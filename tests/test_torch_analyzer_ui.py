"""The port's analyzer UI (app/analyzer_ui.py) against the JAX package's,
both under the headless runtime, and over the port's HTTP server.

The same component tree, the convert tab's format list included;
``do_analyze`` and ``do_normalize`` give the JAX package's reports within
0.01 LU / dB and normalized PCM16 within 1 LSB; ``do_convert`` to WAV,
FLAC, Ogg, MP3 and AAC gives equal bytes (MP3 and AAC where their
libraries load, else the JAX UI's error string).  The device is the
process-wide default (the CPU here).
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.app import analyzer_ui as jui
from audio_raytracing_studio_tpu_torch.app import _gradio_headless as thl
from audio_raytracing_studio_tpu_torch.app import analyzer_ui as tui
from audio_raytracing_studio_tpu_torch.app.server import StudioHTTPServer
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio

torch.set_num_threads(1)

RATE = 16000
TOL = 0.01


@pytest.fixture(autouse=True)
def temp_files_in_tmp_path(tmp_path, monkeypatch):
    """Every handler leaves its result in a ``NamedTemporaryFile(delete=False)``:
    point ``tempfile`` at the test's own directory, which pytest removes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture(autouse=True)
def cpu_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    previous = runtime.set_default_device("cpu")
    yield
    runtime.set_default_device(previous)


def signal(n, channels, seed, gain=1.0):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.3 * np.sin(2 * np.pi * 0.02 * t)[:, None] + 0.1 * r.standard_normal((n, channels))
    return (gain * x).astype(np.float32)


@pytest.fixture
def wavs(tmp_path):
    wavio.write(tmp_path / "stereo.wav", signal(int(0.6 * RATE), 2, 1), RATE)
    wavio.write(tmp_path / "six.wav", signal(int(0.5 * RATE), 6, 2), RATE)
    wavio.write(tmp_path / "silent.wav", np.zeros((RATE // 2, 2), np.float32), RATE)
    (tmp_path / "broken.wav").write_bytes(b"junk" * 100)
    return tmp_path


@pytest.fixture
def demos():
    return tui.build_demo(), jui.build_demo()


def drive(demos, sets, button):
    for demo in demos:
        for label, value in sets.items():
            demo.get_all(label)[-1 if label == "Audiodatei hochladen" and
                                button == "Konvertieren" else 0].value = value
        demo.fire(demo.get(button), "click")


def test_same_components_apart_from_the_format_list(demos):
    """The component trees are equal, the format list of the convert tab
    (wav, mp3, flac, aac, ogg; mp3 first) included."""
    t, j = demos
    assert tui.GRADIO_AVAILABLE is False and isinstance(t, thl.Blocks)
    assert [(type(c).__name__, c.label, c.tab) for c in t.components] == \
        [(type(c).__name__, c.label, c.tab) for c in j.components]
    for a, b in zip(t.components, j.components):
        assert (a.choices, a.value) == (b.choices, b.value), a.label
    assert t.get("Zielformat").choices == ["wav", "mp3", "flac", "aac", "ogg"]
    assert len(t._all_deps) == len(j._all_deps) == 3


@pytest.mark.parametrize("name", ["stereo.wav", "six.wav", "silent.wav"])
def test_do_analyze_matches_jax(demos, wavs, record_property, name):
    drive(demos, {"Audiodatei hochladen": str(wavs / name)}, "Analysieren")
    got, want = (json.loads(d.get("Analyse").value) for d in demos)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], float):
            record_property(k, abs(got[k] - want[k]))
            assert abs(got[k] - want[k]) <= TOL
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("name, target", [("stereo.wav", -20), ("six.wav", -14)])
def test_do_normalize_matches_jax(demos, wavs, record_property, name, target):
    drive(demos, {"Audiodatei hochladen": str(wavs / name), "Ziel-LUFS": target},
          "Auf Ziel-LUFS normalisieren")
    files = [d.get("Normalisierte Datei").value for d in demos]
    got, want = (json.loads(d.get("Bericht").value) for d in demos)
    try:
        assert got["clipped"] == want["clipped"] and got["output_lufs"] == float(target)
        for k in ("input_lufs", "gain_db", "output_lufs"):
            record_property(k, abs(got[k] - want[k]))
            assert abs(got[k] - want[k]) <= TOL
        (a, ra), (b, rb) = (wavio.read(f) for f in files)
        assert ra == rb and a.shape == b.shape
        lsb = int(np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max())
        record_property("pcm16_lsb", lsb)
        assert lsb <= 1
    finally:
        for f in files:
            os.remove(f)


@pytest.mark.parametrize("button, status_label, file_label", [
    ("Analysieren", "Analyse", None),
    ("Auf Ziel-LUFS normalisieren", "Bericht", "Normalisierte Datei"),
    ("Konvertieren", "Status", "Ergebnis"),
])
def test_no_file_answers_equal(demos, button, status_label, file_label):
    drive(demos, {}, button)
    assert demos[0].get(status_label).value == demos[1].get(status_label).value == "Keine Datei."
    if file_label:
        assert demos[0].get(file_label).value is None


@pytest.mark.parametrize("name", ["silent.wav", "broken.wav"])
def test_failures_become_the_same_strings(demos, wavs, name):
    drive(demos, {"Audiodatei hochladen": str(wavs / name)}, "Auf Ziel-LUFS normalisieren")
    assert demos[0].get("Bericht").value == demos[1].get("Bericht").value
    assert demos[0].get("Bericht").value.startswith("Normalisierung fehlgeschlagen: ")
    assert demos[0].get("Normalisierte Datei").value is None
    if name == "broken.wav":
        drive(demos, {"Audiodatei hochladen": str(wavs / name)}, "Analysieren")
        assert demos[0].get("Analyse").value == demos[1].get("Analyse").value
        assert demos[0].get("Analyse").value.startswith("Analyse fehlgeschlagen: ")


def test_do_convert_to_wav_gives_equal_bytes(demos, wavs):
    for demo in demos:
        demo.set_value("Zielformat", "wav")
    drive(demos, {"Audiodatei hochladen": str(wavs / "six.wav")}, "Konvertieren")
    files = [d.get("Ergebnis").value for d in demos]
    try:
        assert all("abgeschlossen" in d.get("Status").value for d in demos)
        assert open(files[0], "rb").read() == open(files[1], "rb").read()
    finally:
        for f in files:
            os.remove(f)


@pytest.mark.parametrize("fmt", ["mp3", "flac", "aac", "ogg"])
def test_do_convert_to_other_formats_says_not_supported(demos, wavs, fmt):
    """Each compressed target at the chosen bitrate: the JAX UI's bytes, or
    where the library is absent its same error string and no file."""
    for demo in demos:
        demo.set_value("Zielformat", fmt)
        demo.set_value("Bitrate (kbit/s)", "128")
    drive(demos, {"Audiodatei hochladen": str(wavs / "stereo.wav")}, "Konvertieren")
    files = [d.get("Ergebnis").value for d in demos]
    status = [d.get("Status").value for d in demos]
    try:
        if files[1] is None:
            assert files[0] is None and status[0] == status[1]
            assert status[0].startswith("Konvertierung fehlgeschlagen: ")
        else:
            assert all("abgeschlossen" in st for st in status)
            assert open(files[0], "rb").read() == open(files[1], "rb").read()
    finally:
        for f in files:
            if f is not None:
                os.remove(f)


def test_handlers_raise_without_a_card_and_main_starts_no_server(wavs, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    runtime.set_default_device("cuda")
    launched = []
    monkeypatch.setattr(thl.Blocks, "launch", lambda self, **kw: launched.append(kw))
    with pytest.raises(RuntimeError, match="CUDA"):
        tui.main()
    assert launched == []
    demo = tui.build_demo()
    demo.set_value("Audiodatei hochladen", str(wavs / "stereo.wav"))
    for button in ("Analysieren", "Auf Ziel-LUFS normalisieren"):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.fire(demo.get(button), "click")
    runtime.set_default_device("cpu")
    tui.main()
    assert launched == [dict(server_name="0.0.0.0", server_port=8862)]


def test_over_http(wavs):
    server = StudioHTTPServer(tui.build_demo(), host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"

    def call(path, data=None, headers={}):
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data,
                                                           headers=headers), timeout=120) as r:
            return r.read()
    try:
        up = json.loads(call("/upload", (wavs / "six.wav").read_bytes(),
                             {"X-Filename": "six.wav"}))["path"]
        comps = json.loads(call("/state"))["components"]
        ids = {c["label"]: c["id"] for c in reversed(comps)}
        out = json.loads(call("/event", json.dumps({
            "id": ids["Analysieren"], "event": "click",
            "set": {str(ids["Audiodatei hochladen"]): up}}).encode()))["components"]
        report = json.loads(next(c for c in out if c["label"] == "Analyse")["value"])
        assert report["Kanäle"] == 6 and report["Abtastrate"] == RATE
        out = json.loads(call("/event", json.dumps({
            "id": ids["Auf Ziel-LUFS normalisieren"], "event": "click",
            "set": {str(ids["Ziel-LUFS"]): -18}}).encode()))["components"]
        norm = next(c for c in out if c["label"] == "Normalisierte Datei")
        body = call(norm["url"])
        assert body == open(norm["value"], "rb").read() and body[:4] == b"RIFF"
        os.remove(norm["value"])
    finally:
        server.stop()
