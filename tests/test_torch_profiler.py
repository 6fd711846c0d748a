"""The port's A/B profiler (analysis/profiler.py) against the JAX package's,
on the CPU: the same two files through both give the same markdown report,
line for line, with the numbers as printed (LUFS to 0.01, dB to 0.1 — the
meters agree far inside that, see test_torch_loudness.py; the largest metric
gap is recorded).  ``backend="oracle"`` gives the float64 report on both sides.
"""

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.analysis import profiler as jprof
from audio_raytracing_studio_tpu.analysis.metrics import calculate_audio_metrics as jmetrics
from audio_raytracing_studio_tpu_torch.analysis import profiler as tprof
from audio_raytracing_studio_tpu_torch.analysis.metrics import calculate_audio_metrics as tmetrics
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio

torch.set_num_threads(1)

RATE = 16000


@pytest.fixture(autouse=True)
def cpu_default():
    previous = runtime.set_default_device("cpu")
    yield
    runtime.set_default_device(previous)


def signal(n, channels, seed, gain=1.0):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.3 * np.sin(2 * np.pi * 0.02 * t)[:, None] + 0.1 * r.standard_normal((n, channels))
    return (gain * x).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("profiler")
    n = int(0.5 * RATE)
    wavio.write(d / "mono.wav", signal(n, 1, 1), RATE)
    wavio.write(d / "stereo.wav", signal(n, 2, 2), RATE)
    wavio.write(d / "loud.wav", signal(n + 900, 2, 3, gain=1.8), RATE)
    wavio.write(d / "six.wav", signal(n + 400, 6, 4), RATE)
    wavio.write(d / "eight.wav", signal(n, 8, 5, gain=0.5), RATE)
    wavio.write(d / "silent.wav", np.zeros((n, 2), np.float32), RATE)
    wavio.write(d / "at8k.wav", signal(n, 2, 6), 8000)
    (d / "broken.wav").write_bytes(b"not a wave file at all")
    return d


PAIRS = [("mono.wav", "stereo.wav"), ("stereo.wav", "six.wav"), ("stereo.wav", "mono.wav"),
         ("mono.wav", "mono.wav"), ("stereo.wav", "loud.wav"), ("loud.wav", "eight.wav"),
         ("silent.wav", "stereo.wav"), ("stereo.wav", "silent.wav"),
         ("silent.wav", "silent.wav")]


@pytest.mark.parametrize("orig, proc", PAIRS)
def test_report_matches_jax_line_for_line(files, record_property, orig, proc):
    got = tprof.run_audio_profiler(str(files / orig), str(files / proc))
    want = jprof.run_audio_profiler(str(files / orig), str(files / proc))
    gap = 0.0
    for name in (orig, proc):
        data, rate = wavio.read(files / name)
        a, b = tmetrics(data, rate), jmetrics(data, rate)
        gap = max([gap] + [abs(a[k] - b[k]) for k in a if np.isfinite(a[k]) and np.isfinite(b[k])])
    record_property("metric_gap", gap)
    assert got.split("\n") == want.split("\n")
    assert "Zusammenfassung" in got


@pytest.mark.parametrize("orig, proc", PAIRS[:3])
def test_oracle_backend_report_equals_jax(files, orig, proc):
    got = tprof.run_audio_profiler(str(files / orig), str(files / proc), backend="oracle")
    want = jprof.run_audio_profiler(str(files / orig), str(files / proc), backend="oracle")
    assert got == want


class _FileObj:
    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("orig, proc", [
    (None, "stereo.wav"), ("stereo.wav", None), ("nope.wav", "stereo.wav"),
    ("stereo.wav", "nope.wav"), ("broken.wav", "stereo.wav"), ("stereo.wav", "at8k.wav"),
])
def test_error_reports_equal(files, orig, proc):
    a = str(files / orig) if orig else None
    b = str(files / proc) if proc else None
    assert tprof.run_audio_profiler(a, b) == jprof.run_audio_profiler(a, b)


def test_file_objects_are_accepted(files):
    a, b = _FileObj(str(files / "mono.wav")), _FileObj(str(files / "six.wav"))
    assert tprof.run_audio_profiler(a, b) == jprof.run_audio_profiler(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_stereo_width_metric_equal(seed):
    x = signal(2000, 2, seed)
    assert tprof.stereo_width_metric(x[:, 0], x[:, 1]) == jprof.stereo_width_metric(x[:, 0], x[:, 1])
    assert tprof.stereo_width_metric(x[:, 0], x[:5, 1]) == 0.0


def test_cuda_default_without_a_card_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    runtime.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.run_audio_profiler(str(files / "mono.wav"), str(files / "stereo.wav"))
