"""The port's visualizer (analysis/visualize.py) against the JAX package's,
on the CPU.

Tolerances: the device STFT's power matrix within ``STFT_TOL`` = 1e-5 of the
matrix's maximum against the JAX device STFT and against
``scipy.signal.spectrogram`` (float32 FFTs of ≤ 4096 points; the port frames
by a strided view, JAX by a gather), odd and even ``nperseg``; the frequency
and time axes, ``detect_layout_names`` and ``spectrogram_nperseg`` equal; the
PNG's pixel size equal, and on the scipy path (no device arithmetic at all)
the pixels equal.  ``torch.hann_window(periodic=True)`` is scipy's "hann"
within 1e-7.  Gaps are recorded with ``record_property``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.signal import get_window

from audio_raytracing_studio_tpu.analysis import visualize as jvis
from audio_raytracing_studio_tpu_torch.analysis import visualize as tvis
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio

torch.set_num_threads(1)

STFT_TOL = 1e-5
RATE = 16000


@pytest.fixture(autouse=True)
def temp_files_in_tmp_path(tmp_path, monkeypatch):
    """Every handler leaves its result in a ``NamedTemporaryFile(delete=False)``:
    point ``tempfile`` at the test's own directory, which pytest removes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture
def cpu_default():
    previous = runtime.set_default_device("cpu")
    yield
    runtime.set_default_device(previous)


def signal(n, channels, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.4 * np.sin(2 * np.pi * 0.031 * t)[:, None] + 0.1 * r.standard_normal((n, channels))
    return x.astype(np.float32)


@pytest.mark.parametrize("channels", range(0, 10))
def test_detect_layout_names_equal(channels):
    assert tvis.detect_layout_names(channels) == jvis.detect_layout_names(channels)


@pytest.mark.parametrize("duration", [0.0, 0.5, 5.0, 5.01, 30.0, 30.01, 600.0])
def test_spectrogram_nperseg_equal(duration):
    assert tvis.spectrogram_nperseg(duration) == jvis.spectrogram_nperseg(duration)


@pytest.mark.parametrize("n", [2, 7, 1024, 1025, 4096])
def test_hann_window_is_scipys(record_property, n):
    ours = torch.hann_window(n, periodic=True, dtype=torch.float64).float().numpy()
    gap = float(np.abs(ours - get_window("hann", n).astype(np.float32)).max())
    record_property("max_abs", gap)
    assert gap <= 1e-7


# 8000 samples at nperseg 1024 (even); 333, 777 and 1023 samples clamp nperseg
# to the odd clip length, one frame, as the plot does for a clip shorter than
# the FFT size (an odd nperseg over several frames does not occur there: both
# packages hop by nperseg // 2 where scipy hops by nperseg - nperseg // 2)
@pytest.mark.parametrize("n, nperseg", [(8000, 1024), (777, 777), (1023, 1023), (4000, 512),
                                        (333, 333), (1024, 1024)])
def test_device_stft_matches_jax_and_scipy(record_property, n, nperseg):
    x = signal(n, 1, n)[:, 0]
    f, t, sxx = tvis.compute_spectrogram(x, RATE, nperseg, use_device=True, device="cpu")
    fj, tj, sj = jvis.compute_spectrogram(x, RATE, nperseg, use_device=True)
    fs, ts, ss = tvis.compute_spectrogram(x, RATE, nperseg)  # scipy on the host
    assert sxx.dtype == np.float32 and sxx.shape == sj.shape == ss.shape
    assert np.array_equal(f, fj) and np.array_equal(t, tj)
    assert np.allclose(f, fs) and np.allclose(t, ts)
    top = float(ss.max())
    gap_jax = float(np.abs(sxx - sj).max()) / top
    gap_scipy = float(np.abs(sxx - ss).max()) / top
    record_property("vs_jax_rel", gap_jax)
    record_property("vs_scipy_rel", gap_scipy)
    assert gap_jax <= STFT_TOL and gap_scipy <= STFT_TOL


def test_host_spectrogram_equals_jax_host():
    x = signal(6000, 1, 3)[:, 0]
    got, want = tvis.compute_spectrogram(x, RATE, 1024), jvis.compute_spectrogram(x, RATE, 1024)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_device_stft_default_device_and_no_card(cpu_default):
    x = signal(3000, 1, 4)[:, 0]
    a = tvis.compute_spectrogram(x, RATE, 1024, use_device=True)[2]  # the default: cpu
    b = tvis.compute_spectrogram(x, RATE, 1024, use_device=True, device="cpu")[2]
    assert np.array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tvis.compute_spectrogram(x, RATE, 1024, use_device=True, device="cuda")


def pixels(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


@pytest.mark.parametrize("channels, seconds", [(1, 0.3), (2, 0.6), (6, 0.5), (8, 0.4)])
def test_png_on_the_scipy_path_has_equal_pixels(tmp_path, channels, seconds):
    path = str(tmp_path / "clip.wav")  # one name: the PNG's title carries it
    wavio.write(path, signal(int(seconds * RATE), channels, channels), RATE)
    got, want = tvis.plot_waveform_and_spectrogram(path, "Original"), \
        jvis.plot_waveform_and_spectrogram(path, "Original")
    try:
        a, b = pixels(got), pixels(want)
        assert a.shape == b.shape
        assert np.array_equal(a, b)
    finally:
        os.remove(got)
        os.remove(want)


def test_png_with_the_device_stft_has_equal_size(tmp_path, cpu_default, record_property):
    path = str(tmp_path / "clip.wav")
    wavio.write(path, signal(int(0.6 * RATE), 2, 5), RATE)
    got = tvis.plot_waveform_and_spectrogram(path, "Bearbeitet", use_device_stft=True)
    want = jvis.plot_waveform_and_spectrogram(path, "Bearbeitet", use_device_stft=True)
    try:
        a, b = pixels(got), pixels(want)
        assert a.shape == b.shape
        record_property("pixels_differing", int((a != b).any(axis=-1).sum()))
    finally:
        os.remove(got)
        os.remove(want)


@pytest.mark.parametrize("bad", [None, "", "/nonexistent/x.wav", 5])
def test_error_png_for_bad_paths_like_jax(bad):
    got, want = tvis.plot_waveform_and_spectrogram(bad), jvis.plot_waveform_and_spectrogram(bad)
    try:
        assert np.array_equal(pixels(got), pixels(want))
    finally:
        os.remove(got)
        os.remove(want)


def test_device_stft_plot_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    path = str(tmp_path / "clip.wav")
    wavio.write(path, signal(4000, 1, 6), RATE)
    previous = runtime.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tvis.plot_waveform_and_spectrogram(path, use_device_stft=True)
    finally:
        runtime.set_default_device(previous)
