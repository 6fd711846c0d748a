"""The port's render API (app/api.py) against the JAX package's, on the CPU.

``apply_raytrace_convolution_3d`` and ``process_audio_main_v41`` take the
reference's argument lists and return its tuples.  Tolerances: the written
PCM16 WAVs within 1 LSB of each other; the metrics in the metrics string
within 0.01 LU / dB (PARITY.md item 2; the strings are printed to 0.01 / 0.1,
so they may differ in a last digit and are compared as numbers); every error
string equal.  Gaps are recorded with ``record_property``.  The device is the
process-wide default, set to the CPU by a fixture that restores it; with a
CUDA default and no card the calls raise.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.app import api as japi
from audio_raytracing_studio_tpu_torch import config
from audio_raytracing_studio_tpu_torch.app import api as tapi
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio

torch.set_num_threads(1)

RATE = 16000
LU_TOL = 0.01


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


def signal(n, channels, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.4 * np.sin(2 * np.pi * 0.02 * t)[:, None] + 0.1 * r.standard_normal((n, channels))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    wavio.write(d / "in.wav", signal(int(0.5 * RATE), 2, 1), RATE)
    wavio.write(d / "mono.wav", signal(int(0.45 * RATE), 1, 2), RATE)
    ir = signal(600, 2, 3) * np.exp(-np.arange(600) / 150.0)[:, None].astype(np.float32)
    wavio.write(d / "ir.wav", ir, RATE)
    wavio.write(d / "ir44k.wav", ir, 44100)
    wavio.write(d / "ir_mono.wav", ir[:, 0], RATE)
    wavio.write(d / "empty.wav", np.zeros((0, 2), np.float32), RATE)
    (d / "tiny.wav").write_bytes(b"RIFF" + b"\0" * 60)       # 64 bytes: under both thresholds
    # > 100 and ≤ 1024 bytes; both packages read a WAV cut short as far as it goes
    (d / "mic_small.wav").write_bytes((d / "in.wav").read_bytes()[:1000])
    (d / "garbage.wav").write_bytes(b"x" * 4000)
    return d


DEFAULTS = dict(
    external_ir_path=None, use_external_ir_cb=False, hall_type_val="Room", room_size_val=100.0,
    diffusion_val=0.5, air_absorption_val=0.1, base_early_level=0.8, base_late_level=0.6,
    dry_wet=0.5, dry_wet_kill_start=0.5, bass_gain=1.0, treble_gain=1.0, x_pos=0.5, y_pos=0.5,
    z_pos=0.5, material="Holz", target_channel_layout="Stereo",
)


def controls(**over):
    """The 16 controls in ``config.PRESET_KEYS`` order."""
    from audio_raytracing_studio_tpu_torch.params import RenderParams

    p = RenderParams(**over)
    return [getattr(p, k) for k in config.PRESET_KEYS]


def pcm(path):
    data, rate = wavio.read(path)
    return np.rint(data * 32768.0).astype(np.int32), rate


def numbers(metrics):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", metrics)]


def hold_pair(record_property, got, want):
    """Both (player, download, metrics) results describe the same render."""
    try:
        assert got[0] == got[1] and want[0] == want[1]
        a, rate_a = pcm(got[0])
        b, rate_b = pcm(want[0])
        assert rate_a == rate_b and a.shape == b.shape
        lsb = int(np.abs(a - b).max())
        record_property("pcm16_lsb", lsb)
        assert lsb <= 1
        assert re.sub(r"-?\d+\.\d+", "#", got[2]) == re.sub(r"-?\d+\.\d+", "#", want[2])
        gap = max(abs(x - y) for x, y in zip(numbers(got[2]), numbers(want[2])))
        record_property("metrics_gap", gap)
        # the string rounds to 0.01 LU / 0.1 dB: allow one printed step beside the meters' gap
        assert abs(numbers(got[2])[0] - numbers(want[2])[0]) <= LU_TOL + 1e-9
        assert gap <= 0.1 + 1e-9
    finally:
        for res in (got, want):
            if res[0] and os.path.exists(res[0]):
                os.remove(res[0])


def test_signatures_equal_the_jax_ones():
    for name in ("apply_raytrace_convolution_3d", "process_audio_main_v41"):
        assert str(inspect.signature(getattr(tapi, name))) == \
            str(inspect.signature(getattr(japi, name)))
    assert "device" not in inspect.signature(tapi.apply_raytrace_convolution_3d).parameters


@pytest.mark.parametrize("over", [
    dict(),
    dict(hall_type_val="Cathedral", room_size_val=300.0, target_channel_layout="5.1 (Standard)",
         bass_gain=1.6, treble_gain=0.7),
    dict(hall_type_val="Plate", target_channel_layout="7.1 (Surround)", z_pos=0.9,
         air_absorption_val=0.0),
    dict(use_external_ir_cb=True, external_ir_path="ir.wav",
         target_channel_layout="5.1.2 (Atmos Light)"),
    dict(use_external_ir_cb=True, external_ir_path="ir44k.wav"),
], ids=["room-stereo", "cathedral-5.1-eq", "plate-7.1", "external-5.1.2", "external-44k1"])
def test_apply_matches_jax(files, record_property, over):
    args = dict(DEFAULTS, **over)
    if args["external_ir_path"]:
        args["external_ir_path"] = str(files / args["external_ir_path"])
    got = tapi.apply_raytrace_convolution_3d(str(files / "in.wav"), seed=3, **args)
    want = japi.apply_raytrace_convolution_3d(str(files / "in.wav"), seed=3, **args)
    hold_pair(record_property, got, want)


def test_apply_equals_the_direct_render(files):
    """The WAV is wavio's PCM16 of the port's ``pipeline.render`` with the same
    params and seed, and the string is ``metrics_string`` of its metrics."""
    from audio_raytracing_studio_tpu_torch.analysis.metrics import metrics_string
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.params import RenderParams

    player, _, text = tapi.apply_raytrace_convolution_3d(str(files / "mono.wav"), seed=9,
                                                         **DEFAULTS)
    audio, rate = wavio.read(files / "mono.wav")
    p = RenderParams(material="Holz", target_layout="Stereo")
    out, metrics = pipeline.render(audio, rate, p, seed=9, return_metrics=True, device="cpu")
    direct = str(files / "direct.wav")
    wavio.write(direct, np.clip(out, -config.OUTPUT_CLIP, config.OUTPUT_CLIP), rate,
                subtype="PCM_16")
    try:
        assert open(player, "rb").read() == open(direct, "rb").read()
        assert text == metrics_string(metrics)
    finally:
        os.remove(player)


def test_seed_past_int32_is_a_seed(files, record_property):
    """``seed=2**32 - 1`` (an ``os.urandom`` value) renders, reproducibly, and
    as the JAX package renders it."""
    src = str(files / "mono.wav")
    got = tapi.apply_raytrace_convolution_3d(src, seed=2**32 - 1, **DEFAULTS)
    again = tapi.apply_raytrace_convolution_3d(src, seed=2**32 - 1, **DEFAULTS)
    other = tapi.apply_raytrace_convolution_3d(src, seed=7, **DEFAULTS)
    try:
        assert open(got[0], "rb").read() == open(again[0], "rb").read()
        assert open(got[0], "rb").read() != open(other[0], "rb").read()
    finally:
        os.remove(again[0])
        os.remove(other[0])
    hold_pair(record_property, got, japi.apply_raytrace_convolution_3d(src, seed=2**32 - 1,
                                                                       **DEFAULTS))


def test_unseeded_calls_differ(files):
    src = str(files / "mono.wav")
    a = tapi.apply_raytrace_convolution_3d(src, **DEFAULTS)
    b = tapi.apply_raytrace_convolution_3d(src, **DEFAULTS)
    try:
        assert open(a[0], "rb").read() != open(b[0], "rb").read()
    finally:
        os.remove(a[0])
        os.remove(b[0])


@pytest.mark.parametrize("src, over", [
    ("in.wav", dict(room_size_val="not a number")),
    ("in.wav", dict(hall_type_val=3)),
    ("in.wav", dict(material=None)),
    ("in.wav", dict(target_channel_layout=5.1)),
    ("in.wav", dict(dry_wet=None)),
    ("in.wav", dict(x_pos=[0.5])),
    ("empty.wav", dict()),
    ("missing.wav", dict()),
    ("garbage.wav", dict()),
    ("in.wav", dict(use_external_ir_cb=True)),
    ("in.wav", dict(use_external_ir_cb=True, external_ir_path="missing_ir.wav")),
    ("in.wav", dict(use_external_ir_cb=True, external_ir_path="ir_mono.wav")),
    ("in.wav", dict(use_external_ir_cb=True, external_ir_path="empty.wav")),
    ("in.wav", dict(use_external_ir_cb=True, external_ir_path="garbage.wav")),
], ids=["bad-number", "hall-not-str", "material-none", "layout-not-str", "dry-wet-none",
        "x-list", "empty-file", "missing-file", "garbage-file", "ir-not-given", "ir-missing",
        "ir-mono", "ir-empty", "ir-garbage"])
def test_apply_error_strings_equal(files, src, over):
    args = dict(DEFAULTS, **over)
    if args["external_ir_path"]:
        args["external_ir_path"] = str(files / args["external_ir_path"])
    got = tapi.apply_raytrace_convolution_3d(str(files / src), seed=1, **args)
    want = japi.apply_raytrace_convolution_3d(str(files / src), seed=1, **args)
    assert got[0] is None and got[1] is None and isinstance(got[2], str)
    assert got == want


def test_mono_ir_message_is_the_references(files):
    args = dict(DEFAULTS, use_external_ir_cb=True, external_ir_path=str(files / "ir_mono.wav"))
    assert tapi.apply_raytrace_convolution_3d(str(files / "in.wav"), **args) == \
        (None, None, "Externe IR muss Stereo sein.")


class _FileObj:
    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("over", [
    dict(target_layout="Stereo"),
    dict(hall_type="Cathedral", room_size=300.0, target_layout="5.1 (Standard)",
         bass_gain=1.6, treble_gain=0.7),
    dict(use_external_ir=True, target_layout="Stereo"),
], ids=["room-stereo", "cathedral-5.1-eq", "external"])
def test_process_main_matches_jax(files, record_property, over):
    ir = _FileObj(str(files / "ir.wav")) if over.get("use_external_ir") else None
    got = tapi.process_audio_main_v41(str(files / "in.wav"), None, ir, *controls(**over), seed=3)
    want = japi.process_audio_main_v41(str(files / "in.wav"), None, ir, *controls(**over), seed=3)
    assert os.path.basename(got[0]).startswith("gradio_out_")
    hold_pair(record_property, got, want)


@pytest.mark.parametrize("upload, mic, picks", [
    ("in.wav", "mono.wav", "in.wav"),          # upload wins over mic
    (None, "mono.wav", "mono.wav"),            # mic alone
    ("tiny.wav", "mono.wav", "mono.wav"),      # upload ≤ 100 bytes: mic
    ("mic_small.wav", None, "mic_small.wav"),  # 1000 bytes pass the upload threshold
    ("missing.wav", "mono.wav", "mono.wav"),
], ids=["upload-wins", "mic-alone", "upload-too-small", "upload-1000-bytes", "upload-missing"])
def test_process_main_source_selection(files, record_property, upload, mic, picks):
    up = str(files / upload) if upload else None
    mc = _FileObj(str(files / mic)) if mic else None
    got = tapi.process_audio_main_v41(up, mc, None, *controls(target_layout="Stereo"), seed=4)
    want = japi.process_audio_main_v41(up, mc, None, *controls(target_layout="Stereo"), seed=4)
    n_src = wavio.read(files / picks)[0].shape[0]
    assert wavio.read(got[0])[0].shape[0] > n_src  # the picked source, with its tail
    hold_pair(record_property, got, want)


@pytest.mark.parametrize("upload, mic", [
    (None, None), ("tiny.wav", None), (None, "mic_small.wav"), ("tiny.wav", "mic_small.wav"),
    ("missing.wav", "missing.wav"), ("", ""),
], ids=["none", "upload-64-bytes", "mic-1000-bytes", "both-too-small", "both-missing", "empty"])
def test_process_main_no_source(files, upload, mic):
    up = str(files / upload) if upload else upload
    mc = str(files / mic) if mic else mic
    got = tapi.process_audio_main_v41(up, mc, None, *controls())
    assert got == japi.process_audio_main_v41(up, mc, None, *controls())
    assert got == (None, None, "Keine gültige Quelle")


@pytest.mark.parametrize("count", [0, 15, 17])
def test_process_main_argument_count(files, count):
    args = (controls() + [None])[:count]
    got = tapi.process_audio_main_v41(str(files / "in.wav"), None, None, *args)
    assert got == japi.process_audio_main_v41(str(files / "in.wav"), None, None, *args)
    assert got[2] == f"Interner Fehler: Argumentanzahl ({count} statt 16)."


def test_process_main_passes_render_errors_through(files):
    args = controls(use_external_ir=True)
    got = tapi.process_audio_main_v41(str(files / "in.wav"), None, str(files / "ir_mono.wav"),
                                      *args)
    assert got == (None, None, "Externe IR muss Stereo sein.")
    assert got == japi.process_audio_main_v41(str(files / "in.wav"), None,
                                              str(files / "ir_mono.wav"), *args)


def test_cuda_default_without_a_card_raises_and_returns_no_string(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    runtime.set_default_device("cuda")
    before = set(os.listdir(os.path.dirname(str(files))))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.apply_raytrace_convolution_3d(str(files / "in.wav"), seed=1, **DEFAULTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.process_audio_main_v41(str(files / "in.wav"), None, None, *controls(), seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):  # even where the inputs are bad
        tapi.apply_raytrace_convolution_3d("/nonexistent.wav", **DEFAULTS)
    assert set(os.listdir(os.path.dirname(str(files)))) == before


def test_default_device_is_read_once_and_settable(monkeypatch):
    runtime.set_default_device(None)
    monkeypatch.setenv("ARS_TORCH_DEVICE", "cpu")
    assert runtime.default_device() == "cpu"
    monkeypatch.setenv("ARS_TORCH_DEVICE", "cuda:3")
    assert runtime.default_device() == "cpu"            # read once
    assert runtime.set_default_device("cuda:1") == "cpu"
    assert runtime.default_device() == "cuda:1"
    runtime.set_default_device(None)
    monkeypatch.delenv("ARS_TORCH_DEVICE")
    assert runtime.default_device() == "cuda"           # the default
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_default_device_under_threads(monkeypatch):
    import threading

    runtime.set_default_device(None)
    monkeypatch.setenv("ARS_TORCH_DEVICE", "cpu")
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(runtime.default_device()))
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == ["cpu"] * 16
