"""The port's on-device meter (metering/loudness.py) against the JAX package's
meter and the float64 oracle meter, on the CPU — the analogues of
tests/test_loudness_jax.py.

Tolerances: ≤ 0.01 LU for LUFS against JAX and the oracle (PARITY.md item 2;
0.02 LU where the JAX test allows it); sample peak and RMS ≤ 1e-3 dB; the
K-weighted signal ≤ 1e-4 against the float64 lfilter (the FIR truncation and
float32 FFT round-off).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.metering import kweighting as kw
from audio_raytracing_studio_tpu.metering import loudness as jl
from audio_raytracing_studio_tpu.oracle import loudness as ol
from audio_raytracing_studio_tpu_torch.metering import loudness as tl

torch.set_num_threads(1)

LU_TOL = 0.01
DB_TOL = 1e-3


def make_signal(rng, seconds=1.2, rate=48000, channels=1):
    t = np.arange(int(seconds * rate)) / rate
    x = (
        0.4 * np.sin(2 * np.pi * 440 * t)[:, None]
        + 0.1 * np.sin(2 * np.pi * 2500 * t)[:, None]
        + 0.03 * rng.standard_normal((len(t), channels))
    ).astype(np.float32)
    return x


def mono_loudness(x: np.ndarray, rate: int) -> float:
    return float(tl.integrated_loudness(torch.from_numpy(x), rate, weights=np.array([1.0])))


def test_k_weight_matches_oracle_and_jax(rng):
    rate = 48000
    x = make_signal(rng, 1.0, rate)[:, 0]
    ours = tl.k_weight(torch.from_numpy(x), rate).numpy()
    assert ours.dtype == np.float32 and ours.shape == x.shape
    assert np.max(np.abs(ours - ol.k_weight(x.astype(np.float64), rate))) < 1e-4
    assert np.max(np.abs(ours - np.asarray(jl.k_weight(jnp.asarray(x), rate)))) < 1e-5


def test_k_weighting_fir_matches_jax():
    for rate in (16000, 44100, 48000):
        np.testing.assert_array_equal(tl.k_weighting_fir(rate), jl.k_weighting_fir(rate))


@pytest.mark.parametrize("rate", [48000, 44100, 16000])
def test_integrated_loudness_matches_oracle_and_jax(rng, rate):
    x = make_signal(rng, 1.2, rate)[:, 0]
    ours = mono_loudness(x, rate)
    assert ours == pytest.approx(ol.integrated_loudness(x, rate), abs=LU_TOL)
    jax = float(jl.integrated_loudness(jnp.asarray(x), rate, weights=np.array([1.0])))
    assert ours == pytest.approx(jax, abs=LU_TOL)


def test_multichannel_weights_match_oracle(rng):
    """BS.1770 channel weights on a 5.1 signal: LFE excluded, surrounds 1.41."""
    rate = 16000
    x = make_signal(rng, 1.2, rate, channels=6) * np.array([1, 0.8, 0.6, 2.0, 0.5, 0.4],
                                                           np.float32)
    ours = float(tl.integrated_loudness(torch.from_numpy(np.ascontiguousarray(x.T)), rate))
    assert ours == pytest.approx(ol.integrated_loudness(x, rate), abs=LU_TOL)


def test_gating_with_quiet_section(rng):
    """A signal with a near-silent half exercises both gates."""
    rate = 48000
    x = make_signal(rng, 0.6, rate)[:, 0]
    x = np.concatenate([x, np.full(int(0.6 * rate), 1e-5, np.float32)])
    ours = mono_loudness(x, rate)
    assert ours == pytest.approx(ol.integrated_loudness(x, rate), abs=0.02)
    jax = float(jl.integrated_loudness(jnp.asarray(x), rate, weights=np.array([1.0])))
    assert ours == pytest.approx(jax, abs=LU_TOL)


def test_997hz_calibration():
    rate = 48000
    t = np.arange(int(1.2 * rate)) / rate
    x = np.sin(2 * np.pi * 997.0 * t).astype(np.float32)
    assert mono_loudness(x, rate) == pytest.approx(-3.01, abs=0.05)


def test_silence_neg_inf():
    assert mono_loudness(np.zeros(48000, np.float32), 48000) == -np.inf
    metrics = tl.audio_metrics(torch.zeros(2, 16000), 16000)
    assert all(float(v) == -np.inf for v in metrics.values())


def test_too_short_gates_out(rng):
    x = make_signal(rng, 0.3, 16000)[:, 0]
    assert mono_loudness(x, 16000) == -np.inf


def test_audio_metrics_matches_oracle_and_jax(rng, tone48k):
    x, rate = tone48k
    stereo = np.stack([x, 0.7 * x], axis=1)
    ours = tl.audio_metrics(torch.from_numpy(np.ascontiguousarray(stereo.T)), rate)
    for ref in (ol.calculate_audio_metrics(stereo, rate),
                {k: float(v) for k, v in jl.audio_metrics(jnp.asarray(stereo.T), rate).items()}):
        assert float(ours["lufs"]) == pytest.approx(ref["lufs"], abs=LU_TOL)
        assert float(ours["true_peak_dbfs"]) == pytest.approx(ref["true_peak_dbfs"], abs=DB_TOL)
        assert float(ours["rms_dbfs"]) == pytest.approx(ref["rms_dbfs"], abs=DB_TOL)


def test_batched_metrics_equal_per_clip(rng):
    """A (B, C, n) batch meters each clip as it meters alone."""
    rate = 16000
    batch = np.stack([make_signal(rng, 1.2, rate, channels=2).T * g for g in (1.0, 0.1, 2.0)])
    got = tl.audio_metrics(torch.from_numpy(np.ascontiguousarray(batch)), rate)
    assert got["lufs"].shape == (3,)
    for b in range(3):
        solo = tl.audio_metrics(torch.from_numpy(np.ascontiguousarray(batch[b])), rate)
        for k in solo:
            assert float(got[k][b]) == pytest.approx(float(solo[k]), abs=1e-5)


def test_masked_metrics_match_trimmed(rng):
    """audio_metrics_masked over a zero-padded batch == audio_metrics over each
    trimmed clip (the batch-bucket metering path)."""
    rate = 16000
    clips = [make_signal(rng, s, rate, channels=2).T for s in (1.3, 0.9)]
    padded = np.zeros((2, 2, clips[0].shape[1] + 5000), np.float32)
    for b, c in enumerate(clips):
        padded[b, :, : c.shape[1]] = c
    lens = [c.shape[1] for c in clips]
    got = tl.audio_metrics_masked(
        torch.from_numpy(padded), rate, torch.tensor(lens),
        torch.tensor([kw.block_count(v, rate) for v in lens]),
    )
    for b, c in enumerate(clips):
        ref = tl.audio_metrics(torch.from_numpy(np.ascontiguousarray(c)), rate)
        assert float(got["lufs"][b]) == pytest.approx(float(ref["lufs"]), abs=1e-3)
        assert float(got["true_peak_dbfs"][b]) == pytest.approx(float(ref["true_peak_dbfs"]),
                                                                abs=1e-5)
        assert float(got["rms_dbfs"][b]) == pytest.approx(float(ref["rms_dbfs"]), abs=1e-4)
        want = jl.audio_metrics_masked(jnp.asarray(padded[b]), rate, jnp.int32(lens[b]),
                                       jnp.int32(kw.block_count(lens[b], rate)))
        assert float(got["lufs"][b]) == pytest.approx(float(want["lufs"]), abs=LU_TOL)


def test_masked_metrics_short_clip_gates_out(rng):
    """valid_len below one 400 ms gating block → LUFS −inf, like trimming."""
    rate = 16000
    x = make_signal(rng, 0.2, rate).T
    padded = np.concatenate([x, np.zeros((1, rate), np.float32)], axis=1)[None]
    got = tl.audio_metrics_masked(torch.from_numpy(padded), rate,
                                  torch.tensor([x.shape[1]]),
                                  torch.tensor([kw.block_count(x.shape[1], rate)]))
    assert np.isneginf(float(got["lufs"][0]))
    assert np.isfinite(float(got["rms_dbfs"][0]))


def test_block_energies_float64_prefix():
    """At 60 s × 48 kHz a float32 prefix difference would carry the prefix's
    round-off into every block; the float64 prefix keeps each block within
    1e-9 relative of a direct float64 sum."""
    rate = 48000
    x = np.random.default_rng(7).uniform(-1, 1, 60 * rate).astype(np.float32)
    z = tl.block_mean_squares(torch.from_numpy(x), rate).numpy()
    lo, hi, nblk = tl._block_bounds(x.size, rate)
    assert z.shape == (nblk,) == (kw.block_count(x.size, rate),)
    x64 = x.astype(np.float64)
    want = np.array([np.sum(x64[a:b] ** 2) for a, b in zip(lo, hi)]) / (0.4 * rate)
    assert np.max(np.abs(z / want - 1.0)) < 1e-9


def test_oversampled_true_peak_exceeds_sample_peak():
    """An inter-sample peak invisible to sample metering is caught at 4×."""
    rate = 48000
    t = np.arange(rate // 4) / rate
    x = (0.9 * np.sin(2 * np.pi * (rate / 4 + 11.7) * t + 0.4)).astype(np.float32)
    sp = float(tl.sample_peak_dbfs(torch.from_numpy(x)[None]))
    tp = float(tl.oversampled_true_peak_dbfs(torch.from_numpy(x)))
    assert tp >= sp - 1e-4
    assert tp == pytest.approx(20 * np.log10(0.9), abs=0.05)
    assert tp == pytest.approx(float(jl.oversampled_true_peak_dbfs(jnp.asarray(x))), abs=1e-4)
