"""The port's Fourier resampler (ops/resample.py) against scipy.signal.resample
and the JAX package's ``resample_fft``, on the CPU.

Tolerance: ≤ 5e-6 of max(1, peak) — float32 FFTs at the exact lengths, the
bound tests/test_resample.py holds the JAX version to.
"""

import numpy as np
import pytest
import torch
from scipy import signal

from audio_raytracing_studio_tpu.ops import resample as jresample
from audio_raytracing_studio_tpu_torch.ops import resample

torch.set_num_threads(1)

TOL = 5e-6


@pytest.mark.parametrize(
    "n,num",
    [(1000, 441), (1000, 2205), (999, 441), (999, 440), (1000, 440),
     (441, 480), (480, 441), (64, 128), (128, 64), (100, 101), (2205, 2400)],
)
def test_matches_scipy_and_jax(rng, n, num):
    x = rng.standard_normal(n).astype(np.float32)
    got = resample.resample_fft(x, num)
    assert got.dtype == torch.float32 and got.shape == (num,)
    want = signal.resample(x, num)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() < bound
    assert np.abs(got.numpy() - np.asarray(jresample.resample_fft(x, num))).max() < bound


def test_multichannel(rng):
    x = rng.standard_normal((500, 3)).astype(np.float32)
    got = resample.resample_fft(torch.from_numpy(x), 750)
    assert got.shape == (750, 3)
    assert np.abs(got.numpy() - signal.resample(x, 750, axis=0)).max() < TOL


def test_identity(rng):
    x = rng.standard_normal(321).astype(np.float32)
    assert np.array_equal(resample.resample_fft(x, 321).numpy(), x)


def test_rejects_degenerate():
    with pytest.raises(ValueError):
        resample.resample_fft(np.zeros(1, np.float32), 10)
    with pytest.raises(ValueError):
        resample.resample_fft(np.zeros(10, np.float32), 0)
