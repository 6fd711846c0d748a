"""The port's binaural downmix (ops/binaural.py) against the JAX package's, on
the CPU, and the behavioral checks of tests/test_binaural.py on the port.

Tolerances: ≤ 1e-5 max-abs on the ears — one float32 rfft/irfft pair at the
same power-of-two size in two FFT libraries and a channel sum in another
order; ≤ 1e-6 on the complex64 ear-filter table, built in float64 on the
device by the port and by NumPy in the JAX package.  Each comparison records its gap with ``record_property`` (``--junitxml`` keeps them).
"""

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.ops import binaural as jbin
from audio_raytracing_studio_tpu_torch import config
from audio_raytracing_studio_tpu_torch.ops import binaural as tbin
from audio_raytracing_studio_tpu_torch.parallel.sharding import bucket_length

torch.set_num_threads(1)

TOL = 1e-5
TABLE_TOL = 1e-6
LAYOUTS = list(config.CHANNEL_LAYOUTS)


def surround(n, channels, seed):
    return (np.random.default_rng(seed).standard_normal((n, channels)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("rate", [16000, 48000, 384000])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_matches_jax(record_property, layout, rate):
    x = surround(2400, config.CHANNEL_LAYOUTS[layout]["channels"], seed=rate)
    got = tbin.binauralize(x, rate, layout, device="cpu")
    want = np.asarray(jbin.binauralize(x, rate, layout))
    assert got.dtype == np.float32 and got.shape == want.shape == (2400, 2)
    err = float(np.abs(got - want).max())
    record_property("max_abs", err)
    assert err <= TOL


@pytest.mark.parametrize("n", [4700, 4800, 4850])
def test_lengths_of_one_bucket_match_jax(record_property, n):
    """4700, 4800 and 4850 samples share the 24,000-sample bucket at 48 kHz,
    hence one transform size; each output keeps its own length."""
    rate = 48000
    names = tuple(config.CHANNEL_LAYOUTS["5.1 (Standard)"]["names"])
    assert bucket_length(n, rate) == 24000
    assert tbin.transform_size(names, n, rate) == tbin.transform_size(names, 4700, rate)
    x = np.zeros((n, 6), np.float32)
    x[n // 2, 0] = 1.0
    got = tbin.binauralize(x, rate, "5.1 (Standard)", device="cpu")
    want = np.asarray(jbin.binauralize(x, rate, "5.1 (Standard)"))
    assert got.shape == (n, 2) and np.abs(got).max() > 0.1
    err = float(np.abs(got - want).max())
    record_property("max_abs", err)
    assert err <= TOL


@pytest.mark.parametrize("rate, n", [(16000, 4800), (48000, 4800), (384000, 2048),
                                     (44100, 100)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_table_matches_jax(record_property, layout, rate, n):
    names = tuple(config.CHANNEL_LAYOUTS[layout]["names"])
    nfft = tbin.transform_size(names, n, rate)
    want = jbin._binaural_table(names, rate, nfft)
    got = tbin._binaural_table(names, rate, nfft, "cpu")
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    record_property("max_abs", err)
    assert err <= TABLE_TOL


def click_in_channel(ch, channels=6, n=4800, rate=48000):
    x = np.zeros((n, channels), np.float32)
    x[n // 2, ch] = 1.0
    return x, rate


def check_itd_and_ild():
    """RL (-110°) source: left ear earlier and louder than right."""
    x, rate = click_in_channel(4)
    out = tbin.binauralize(x, rate, "5.1 (Standard)", device="cpu")
    left, right = out[:, 0], out[:, 1]
    assert np.sum(left**2) > 2.0 * np.sum(right**2)
    expected_itd = int(0.0875 / 343.0 * (np.deg2rad(110) + np.sin(np.deg2rad(110))) * rate)
    assert np.argmax(np.abs(right)) - np.argmax(np.abs(left)) == pytest.approx(expected_itd, abs=2)


def check_center_symmetric():
    x, rate = click_in_channel(2)
    out = tbin.binauralize(x, rate, "5.1 (Standard)", device="cpu")
    np.testing.assert_allclose(out[:, 0], out[:, 1], atol=1e-6)


def check_energy_reasonable():
    x = surround(9600, 6, seed=0) * 0.5
    out = tbin.binauralize(x, 48000, "5.1 (Standard)", device="cpu")
    assert 0.2 * np.sum(x**2) < np.sum(out**2) < 1.5 * np.sum(x**2)


def check_high_rate_itd_does_not_wrap():
    """At 384 kHz a fully lateral source's far-ear delay (~280 samples)
    exceeds a fixed 256-sample pad; the headroom scales with the rate, so
    nothing of a click at the end wraps round to the start."""
    n = 2048
    x = np.zeros((n, 6), np.float32)
    x[n - 1, 4] = 1.0
    out = tbin.binauralize(x, 384000, "5.1 (Standard)", device="cpu")
    assert np.max(np.abs(out[: n // 2])) < 1e-4
    assert np.max(np.abs(out)) > 0.05


def check_layout_mismatch_rejected():
    with pytest.raises(ValueError, match="does not match"):
        tbin.binauralize(np.zeros((100, 6), np.float32), 48000, "Stereo", device="cpu")


@pytest.mark.parametrize("check", [check_itd_and_ild, check_center_symmetric,
                                   check_energy_reasonable, check_high_rate_itd_does_not_wrap,
                                   check_layout_mismatch_rejected])
def test_behavior(check):
    check()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbin.binauralize(np.zeros((100, 6), np.float32), 48000, "5.1 (Standard)")
