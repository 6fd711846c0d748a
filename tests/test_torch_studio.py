"""The port's 4-tab studio (app/studio.py over app/_gradio_headless.py)
against the JAX package's, both under their headless runtimes on the CPU.

The same actions go through both event graphs and the whole component state
is compared after each: types, labels, listeners, choices, interactivity and
values are **equal**; a value that names a file is compared by content — PNG
pixels equal, preset ZIPs with equal members, rendered WAVs within 1 PCM16
LSB and their metrics strings within 0.01 LU / 0.1 dB as printed.  The only
texts allowed to differ are the two Markdown blocks that name the backend
(the title and the help page).  The process-wide device is the CPU, set by a
fixture that restores it.
"""

import os
import re
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from audio_raytracing_studio_tpu.app import _gradio_headless as jhl
from audio_raytracing_studio_tpu.app import marker as jmarker
from audio_raytracing_studio_tpu.app import studio as jstudio
from audio_raytracing_studio_tpu.params import RenderParams as JParams
from audio_raytracing_studio_tpu.utils.presets import PresetStore as JStore
from audio_raytracing_studio_tpu_torch import config
from audio_raytracing_studio_tpu_torch.app import _gradio_headless as thl
from audio_raytracing_studio_tpu_torch.app import marker as tmarker
from audio_raytracing_studio_tpu_torch.app import studio as tstudio
from audio_raytracing_studio_tpu_torch.params import RenderParams as TParams
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio
from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore as TStore

torch.set_num_threads(1)

RATE = 16000
PROCESS = "➡️ Verarbeiten & Anhören!"


@pytest.fixture(autouse=True)
def temp_files_in_tmp_path(tmp_path, monkeypatch):
    """Every handler leaves its result in a ``NamedTemporaryFile(delete=False)``:
    point ``tempfile`` at the test's own directory, which pytest removes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture(autouse=True)
def cpu_default():
    previous = runtime.set_default_device("cpu")
    yield
    runtime.set_default_device(previous)


class Pair:
    """The two demos, each with its own preset store; the map asset (in the
    working directory) is shared, and equal (test_torch_marker.py)."""

    def __init__(self, root):
        (root / "t").mkdir()
        (root / "j").mkdir()
        tmarker.ensure_map_asset()
        self.stores = (TStore(str(root / "t")), JStore(str(root / "j")))
        self.demos = (tstudio.build_demo(self.stores[0]), jstudio.build_demo(self.stores[1]))
        self.hl = (thl, jhl)

    def each(self, action):
        for demo, hl in zip(self.demos, self.hl):
            action(demo, hl)

    def startup(self):
        self.each(lambda d, _: d.startup())

    def set(self, label, value):
        self.each(lambda d, _: d.set_value(label, value))

    def fire(self, label, event="click", index=None, nth=0):
        def go(demo, hl):
            comp = demo.get_all(label)[nth]
            data = hl.SelectData(index=index) if event == "select" else None
            demo.fire(comp, event, event_data=data)
        self.each(go)

    def values(self, label):
        return tuple(d.get(label).value for d in self.demos)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return Pair(tmp_path)


@pytest.fixture
def short_wav(tmp_path):
    t = np.arange(int(0.5 * RATE)) / RATE
    x = (0.5 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    path = tmp_path / "ui_in.wav"
    wavio.write(path, np.stack([x, 0.5 * x], axis=1), RATE)
    return str(path)


def pixels(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


def same_file(a, b, record_property=None):
    """Two file-valued component values hold the same content."""
    ext = os.path.splitext(a)[1]
    assert ext == os.path.splitext(b)[1]
    if ext == ".png":
        assert np.array_equal(pixels(a), pixels(b))
    elif ext == ".wav":
        (x, ra), (y, rb) = wavio.read(a), wavio.read(b)
        assert ra == rb and x.shape == y.shape
        lsb = int(np.abs(np.rint(x * 32768.0) - np.rint(y * 32768.0)).max())
        if record_property:
            record_property("pcm16_lsb", lsb)
        assert lsb <= 1
    elif ext == ".zip":
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert sorted(za.namelist()) == sorted(zb.namelist())
            for name in za.namelist():
                assert za.read(name) == zb.read(name)
    else:
        assert open(a, "rb").read() == open(b, "rb").read()


def is_file(v):
    return isinstance(v, str) and os.path.isabs(v) and os.path.isfile(v)


def numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]


def hold_state(pair, record_property=None):
    """Every component of the two demos is in the same state."""
    t_demo, j_demo = pair.demos
    assert len(t_demo.components) == len(j_demo.components)
    for a, b in zip(t_demo.components, j_demo.components):
        where = (type(a).__name__, a.label)
        assert type(a).__name__ == type(b).__name__ and a.label == b.label, where
        assert a.interactive == b.interactive and a.visible == b.visible, where
        assert a.choices == b.choices and a.tab == b.tab, where
        for attr in ("minimum", "maximum", "step"):
            assert getattr(a, attr, None) == getattr(b, attr, None), where
        if is_file(a.value) and is_file(b.value):
            same_file(a.value, b.value, record_property)
        elif isinstance(b.value, str) and b.value.startswith("LUFS: "):
            assert re.sub(r"-?\d+\.\d+", "#", a.value) == re.sub(r"-?\d+\.\d+", "#", b.value)
            gaps = [abs(x - y) for x, y in zip(numbers(a.value), numbers(b.value))]
            assert gaps[0] <= 0.01 + 1e-9 and max(gaps) <= 0.1 + 1e-9, (a.value, b.value)
        elif isinstance(a, thl.Markdown) and isinstance(b.value, str) and "TPU" in b.value:
            assert "TPU" not in a.value and "Audio Raytracing Studio" in a.value
        else:
            assert a.value == b.value, where


def listeners(demo):
    index = {id(c): i for i, c in enumerate(demo.components)}
    index[id(demo)] = "blocks"

    def key(dep):
        trigger = index[id(dep.trigger)] if id(dep.trigger) in index else "then"
        return (trigger, dep.event, [index[id(c)] for c in dep.inputs],
                [index[id(c)] for c in dep.outputs], [key(d) for d in dep.after])
    return [key(d) for d in demo._all_deps]


def test_runs_on_the_headless_runtime(pair):
    assert tstudio.GRADIO_AVAILABLE is False
    assert isinstance(pair.demos[0], thl.Blocks)
    assert pair.demos[0].title == pair.demos[1].title


def test_same_components_and_listeners(pair):
    hold_state(pair)
    assert listeners(pair.demos[0]) == listeners(pair.demos[1])
    assert len(pair.demos[0].components) > 50
    tabs = [c.tab for c in pair.demos[0].components]
    assert len(dict.fromkeys(t for t in tabs if t)) == 4


def test_startup_sets_every_initializer_output(pair):
    # the reference's "28 outputs" initializer: here the preset list, the 16
    # controls, the map, the marker, the hall info, the 8 interactivity
    # targets and the metrics line — 29 in both packages
    t_demo, j_demo = pair.demos
    for demo in pair.demos:
        (load,) = demo.deps_for(demo, "load")
        assert len(load.outputs) == 1 + 16 + 3 + 8 + 1
    updates = tstudio.on_start(pair.stores[0])
    assert len(updates) == 29 == len(jstudio.on_start(pair.stores[1]))
    pair.startup()
    hold_state(pair)
    assert pair.values("📊 Ergebnis-Metriken (Gesamt)")[0] == "Bereit. Bitte Audio laden."
    assert is_file(t_demo.get("🎯 Position (X/Y)").value)
    assert t_demo.get("📂 Externe IR-Datei (Stereo WAV)").interactive is False


def test_startup_restores_last_preset(pair):
    kwargs = dict(hall_type="Plate", room_size=40.0, x_pos=0.2, use_external_ir=True)
    pair.stores[0].save("startup check", TParams(**kwargs))
    pair.stores[1].save("startup check", JParams(**kwargs))
    pair.startup()
    hold_state(pair)
    assert pair.values("🏛️ Hall-Typ") == ("Plate", "Plate")
    assert pair.demos[0].get("📂 Presets (v4)").value == "startup_check_v4.json"
    assert pair.demos[0].get("🏛️ Hall-Typ").interactive is False  # external IR preset


def test_startup_with_a_broken_last_preset(pair):
    for store in pair.stores:
        store.ensure_dir()
        store.save_last("gone_v4.json")
    pair.startup()
    hold_state(pair)
    assert pair.stores[0].load_last() == pair.stores[1].load_last()


@pytest.mark.parametrize("hall", sorted(config.HALL_PRESETS))
def test_hall_info_change(pair, hall):
    pair.startup()
    pair.set("🏛️ Hall-Typ", hall)
    pair.fire("🏛️ Hall-Typ", "change")
    hold_state(pair)
    assert tstudio.update_hall_info(hall) == jstudio.update_hall_info(hall)
    assert tstudio.update_hall_info("?") == jstudio.update_hall_info("?")


def test_external_ir_toggle(pair):
    pair.startup()
    for on in (True, False):
        pair.set("💡 Externe Stereo IR verwenden?", on)
        pair.fire("💡 Externe Stereo IR verwenden?", "change")
        hold_state(pair)
        assert pair.demos[0].get("📂 Externe IR-Datei (Stereo WAV)").interactive is on
        for label in ["🏛️ Hall-Typ", "🧱 Material", "📏 Raumgröße (m³)", "💫 Diffusion",
                      "💨 Luftabsorption", "Basis Early Level", "Basis Late Level"]:
            assert pair.demos[0].get(label).interactive is (not on), label
    assert tstudio.toggle_ir_controls(1) == jstudio.toggle_ir_controls(1)


@pytest.mark.parametrize("index", [(450, 100), (0, 0), (599, 399), (9000, -5), (120,), None])
def test_map_click_sets_the_sliders(pair, index):
    pair.startup()
    before = pair.values("↔️ X (L/R)")
    pair.fire("Karte (Klicken für X/Y)", "select", index=index)
    hold_state(pair)
    if index is None or len(index) < 2:
        assert pair.values("↔️ X (L/R)") == before
    elif index == (450, 100):
        assert pair.demos[0].get("↔️ X (L/R)").value == pytest.approx(0.75)
        assert pair.demos[0].get("↕️ Y (F/B)").value == pytest.approx(0.25)


def test_map_click_handler_keeps_its_selectdata_annotation():
    import typing

    assert typing.get_type_hints(tstudio.on_map_click).get("evt") is tstudio.gr.SelectData


def test_slider_input_redraws_the_marker(pair):
    pair.startup()
    first = pair.demos[0].get("🎯 Position (X/Y)").value
    pair.set("↔️ X (L/R)", 0.9)
    pair.fire("↔️ X (L/R)", "input")
    pair.set("↕️ Y (F/B)", 0.1)
    pair.fire("↕️ Y (F/B)", "input")
    hold_state(pair)
    second = pair.demos[0].get("🎯 Position (X/Y)").value
    assert second != first and not np.array_equal(pixels(first), pixels(second))


def test_process_button_end_to_end(pair, short_wav, record_property, monkeypatch):
    # the button passes no seed, so both packages draw one from os.urandom: pin it
    monkeypatch.setattr(os, "urandom", lambda n: bytes([5, 0, 0, 128])[:n])
    pair.startup()
    pair.set("🔊 Audio hochladen", short_wav)
    pair.set("🎯 Ziel-Layout", "5.1 (Standard)")
    pair.set("Bass Gain", 1.6)
    pair.fire(PROCESS)
    hold_state(pair, record_property)
    out = pair.demos[0].get("🎧 Ergebnis anhören").value
    assert is_file(out) and out == pair.demos[0].get("💾 Download Ergebnis").value
    data, rate = wavio.read(out)
    assert rate == RATE and data.shape[1] == 6
    for v in pair.values("🎧 Ergebnis anhören"):
        os.remove(v)


def test_process_button_without_a_source(pair):
    pair.startup()
    pair.fire(PROCESS)
    hold_state(pair)
    assert pair.values("📊 Ergebnis-Metriken (Gesamt)")[0] == "Keine gültige Quelle"
    assert pair.values("🎧 Ergebnis anhören") == (None, None)


def test_visualizer_profiler_and_load_last_result(pair, short_wav, monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes([6, 0, 0, 0])[:n])
    pair.startup()
    pair.set("🔊 Audio hochladen", short_wav)
    pair.set("🎯 Ziel-Layout", "Stereo")
    pair.fire(PROCESS)
    pair.fire("Lade letztes Ergebnis (Bearb.)", nth=0)
    pair.fire("Lade letztes Ergebnis (Bearb.)", nth=1)
    for demo in pair.demos:
        done = demo.get("💾 Download Ergebnis").value
        assert demo.get("🔍 Bearbeitet (Visualizer)").value == done
        assert demo.get("Lade Bearbeitet (Profiler)").value == done
    pair.set("🔍 Original (Visualizer)", short_wav)
    pair.set("Lade Original (Profiler)", short_wav)
    pair.fire("📊 Visualisieren")
    pair.fire("🚀 Analysieren!")
    for demo in pair.demos:
        assert demo.get("🔵 Original Vis").value.endswith(".png")
        assert "Zusammenfassung" in demo.get("📋 Analysebericht").value
    # the original's PNG and the report's structure are equal; the processed
    # side shows two renders that differ within 1 LSB, so only its size is held
    same_file(*pair.values("🔵 Original Vis"))
    a, b = (pixels(v) for v in pair.values("🟠 Bearbeitet Vis"))
    assert a.shape == b.shape
    ra, rb = (v.split("\n") for v in pair.values("📋 Analysebericht"))
    assert len(ra) == len(rb)
    assert [re.sub(r"[-+]?\d+\.\d+", "#", x) for x in ra] == \
        [re.sub(r"[-+]?\d+\.\d+", "#", x) for x in rb]
    for label in ("🔵 Original Vis", "🟠 Bearbeitet Vis", "🎧 Ergebnis anhören"):
        for v in pair.values(label):
            os.remove(v)


def test_preset_save_load_delete(pair):
    pair.startup()
    pair.set("🏛️ Hall-Typ", "Cathedral")
    pair.set("📏 Raumgröße (m³)", 600.0)
    pair.set("Dry/Wet Mix", 0.8)
    pair.set("↔️ X (L/R)", 0.2)
    pair.set("📝 Preset-Name", "UI Zyklus")
    pair.fire("💾 Speichern")
    hold_state(pair)
    assert pair.demos[0].get("Status").value.startswith("✅")
    assert pair.demos[0].get("📂 Presets (v4)").value == "UI_Zyklus_v4.json"
    t_file = os.path.join(pair.stores[0].preset_dir, "UI_Zyklus_v4.json")
    j_file = os.path.join(pair.stores[1].preset_dir, "UI_Zyklus_v4.json")
    assert open(t_file).read() == open(j_file).read()

    pair.set("🏛️ Hall-Typ", "Plate")
    pair.set("📏 Raumgröße (m³)", 10.0)
    pair.set("↔️ X (L/R)", 0.9)
    pair.fire("📥 Laden")
    hold_state(pair)
    assert pair.values("🏛️ Hall-Typ")[0] == "Cathedral"
    assert pair.values("📏 Raumgröße (m³)")[0] == 600.0
    assert pair.values("Status")[0] == "Preset 'UI_Zyklus_v4.json' geladen."

    pair.fire("🗑️ Löschen")
    hold_state(pair)
    assert "gelöscht" in pair.values("Status")[0]
    assert pair.stores[0].list_presets() == pair.stores[1].list_presets() == []
    pair.fire("🗑️ Löschen")
    hold_state(pair)
    assert "Kein Preset zum Löschen" in pair.values("Status")[0]


@pytest.mark.parametrize("name", ["???!!!", "", "   "])
def test_preset_save_with_a_bad_name(pair, name):
    pair.startup()
    pair.set("📝 Preset-Name", name)
    pair.fire("💾 Speichern")
    hold_state(pair)
    assert pair.values("Status")[0] == "⚠️ Ungültiger Preset-Name."


def test_preset_refresh_load_nothing_and_zip_export(pair):
    pair.startup()
    pair.fire("📥 Laden")  # nothing selected
    hold_state(pair)
    assert pair.values("Status")[0] == "Kein Preset gewählt."
    pair.stores[0].save("extern angelegt", TParams(diffusion=0.25))
    pair.stores[1].save("extern angelegt", JParams(diffusion=0.25))
    pair.fire("🔄 Liste neu laden")
    hold_state(pair)
    assert "extern_angelegt_v4.json" in pair.demos[0].get("📂 Presets (v4)").choices
    pair.fire("📦 ZIP Export")
    hold_state(pair)
    assert pair.values("Status")[0] == "ZIP Export erfolgreich."
    for v in pair.values("📦 Download ZIP"):
        os.remove(v)


def test_a_preset_saved_by_one_package_loads_in_the_other(pair):
    pair.startup()
    pair.stores[1].save("von jax", JParams(hall_type="Plate", z_pos=0.9))
    os.replace(os.path.join(pair.stores[1].preset_dir, "von_jax_v4.json"),
               os.path.join(pair.stores[0].preset_dir, "von_jax_v4.json"))
    updates = tstudio.load_preset(pair.stores[0], "von_jax_v4.json")
    assert [u["value"] for u in updates] == \
        [getattr(TParams(hall_type="Plate", z_pos=0.9), k) for k in config.PRESET_KEYS]


def test_main_resolves_the_device_before_anything_is_served(tmp_path, monkeypatch):
    """``main`` with a CUDA device and no card raises naming CUDA: no store,
    no map and no server is created; with ``device="cpu"`` it builds and
    launches on the given address."""
    monkeypatch.chdir(tmp_path)
    launched = {}
    monkeypatch.setattr(thl.Blocks, "launch",
                        lambda self, **kw: launched.update(kw, blocks=self))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tstudio.main(server_name="127.0.0.1", server_port=0, device="cuda")
        assert not launched and os.listdir(tmp_path) == []
    tstudio.main(server_name="127.0.0.1", server_port=8899, device="cpu")
    assert launched["server_name"] == "127.0.0.1" and launched["server_port"] == 8899
    assert runtime.default_device() == "cpu"
    assert os.path.exists(config.BASE_SURROUND_MAP_PATH)


def test_launch_serves_through_the_ports_own_server(pair, monkeypatch):
    from audio_raytracing_studio_tpu_torch.app import server as srv

    calls = {}
    monkeypatch.setattr(srv, "serve", lambda blocks, host="0.0.0.0", port=0:
                        calls.update(args=(blocks, host, port)))
    pair.demos[0].launch(server_name="127.0.0.1", server_port=8861)
    assert calls["args"] == (pair.demos[0], "127.0.0.1", 8861)


def run_module(args, cwd, device_env):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "ARS_TORCH_DEVICE")}
    env["PYTHONPATH"] = repo
    env["TMPDIR"] = str(cwd)
    if device_env:
        env["ARS_TORCH_DEVICE"] = device_env
    return subprocess.run([sys.executable, "-m", "audio_raytracing_studio_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args, device_env", [([], None), (["--device", "cuda"], "cpu"),
                                              ([], "cuda:0")],
                         ids=["default", "flag-over-environment", "environment"])
def test_python_m_without_a_card_exits_1_naming_cuda(tmp_path, args, device_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    proc = run_module([*args, "--host", "127.0.0.1", "--port", "0"], tmp_path, device_env)
    assert proc.returncode == 1 and "CUDA" in proc.stderr and "läuft auf" not in proc.stdout
    assert os.listdir(tmp_path) == []  # no presets, no map: nothing was started


def test_python_m_serves_on_the_cpu_when_asked(tmp_path):
    import json
    import re as _re
    import select
    import subprocess
    import sys
    import urllib.request

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "ARS_TORCH_DEVICE"}
    env["PYTHONPATH"] = repo
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "audio_raytracing_studio_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 90)
        assert ready, "the studio printed nothing within 90 s"
        line = proc.stdout.readline()
        port = int(_re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=30) as r:
            comps = json.loads(r.read())["components"]
        assert any(c["label"] == PROCESS for c in comps)
        assert os.path.exists(tmp_path / config.BASE_SURROUND_MAP_PATH)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
