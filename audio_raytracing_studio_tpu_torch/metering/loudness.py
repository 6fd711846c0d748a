"""On-device loudness / peak / RMS metering — port of
``audio_raytracing_studio_tpu/metering/loudness.py``.

The K-weighting biquads become one 8192-tap FIR (their impulse response,
decayed below 1e-18 there) applied through ``torch.fft`` — cuFFT on the GPU.
Gating blocks are mean squares gathered from a cumulative energy sum at
pyloudnorm's block grid, and both BS.1770 gates are masked reductions.

Every function takes a batch: signals are (..., n) over the last axis and
the reductions keep the leading dims, so ``audio_metrics`` meters a whole
(B, C, n) render batch in one pass.

Precision: the energy prefix is carried in float64.  A 400 ms block is
~1/150 of a 60 s clip's energy, and a float32 prefix difference would carry
the prefix's round-off into it (the JAX package bounds this with XLA's
log-depth scan; ``torch.cumsum`` on CUDA accumulates another way).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..ops.convolution import fast_fft_length
from ..ops.ir_synth import to_device
from . import kweighting as kw

K_FIR_LENGTH = 8192


@functools.lru_cache(maxsize=16)
def k_weighting_fir(rate: int, length: int = K_FIR_LENGTH) -> np.ndarray:
    """Truncated float64 impulse response of the K-weighting cascade (host)."""
    from scipy.signal import lfilter

    impulse = np.zeros(length, dtype=np.float64)
    impulse[0] = 1.0
    out = impulse
    for b, a in kw.k_weighting_coefficients(rate):
        out = lfilter(b, a, out)
    return out


@functools.lru_cache(maxsize=64)
def _block_bounds(num_samples: int, rate: int):
    """(lower, upper) sample indices of each 400 ms gating block (host)."""
    step = 1.0 - kw.BLOCK_OVERLAP
    num_blocks = kw.block_count(num_samples, rate)
    j = np.arange(max(num_blocks, 1))
    lo = (kw.BLOCK_SECONDS * (j * step) * rate).astype(np.int64)
    hi = (kw.BLOCK_SECONDS * (j * step + 1) * rate).astype(np.int64)
    return lo, np.minimum(hi, num_samples), num_blocks


def k_weight(signal: torch.Tensor, rate: int) -> torch.Tensor:
    """K-weighting prefilter over the last axis (causal FIR, float32).

    One kernel spectrum broadcast against every row; the transform runs at
    the fast grid ≥ n + 8191 (exact for linear convolution).
    """
    n = signal.shape[-1]
    fir = to_device(k_weighting_fir(int(rate)).astype(np.float32), signal.device)
    nfft = fast_fft_length(n + fir.shape[0] - 1)
    out = torch.fft.irfft(
        torch.fft.rfft(signal, n=nfft) * torch.fft.rfft(fir, n=nfft), n=nfft
    )
    return out[..., :n]


def block_mean_squares(
    signal: torch.Tensor, rate: int, valid_len: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-gating-block mean square z_j over the last axis → (..., J) float64.

    z_j = Σ x² / (T_g·rate) from a float64 energy prefix gathered at the
    block grid of the (padded) length.  ``valid_len`` (leading-dims int
    tensor) clamps every block bound to the clip's true length, so samples
    past it never enter a block — pyloudnorm truncates a final partial block
    the same way.
    """
    n = signal.shape[-1]
    lo, hi, num_blocks = _block_bounds(n, int(rate))
    if num_blocks <= 0:
        return torch.zeros(signal.shape[:-1] + (0,), dtype=torch.float64, device=signal.device)
    energy = torch.cumsum(signal.to(torch.float64).square(), dim=-1)
    prefix = torch.nn.functional.pad(energy, (1, 0))
    lo_t = to_device(lo, signal.device)
    hi_t = to_device(hi, signal.device)
    if valid_len is None:
        block_energy = prefix[..., hi_t] - prefix[..., lo_t]
    else:
        vl = valid_len.to(torch.int64).reshape(valid_len.shape + (1,) * (prefix.dim() - valid_len.dim()))
        hi_c = torch.minimum(hi_t, vl).expand(prefix.shape[:-1] + (num_blocks,))
        lo_c = torch.minimum(lo_t, vl).expand(prefix.shape[:-1] + (num_blocks,))
        block_energy = prefix.gather(-1, hi_c) - prefix.gather(-1, lo_c)
    return block_energy / (kw.BLOCK_SECONDS * rate)


def gated_loudness_from_blocks(
    z: torch.Tensor, w: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """BS.1770 two-stage gating over block mean squares z (..., C, J) with
    channel weights w (C,) → (...,) LUFS; −inf where everything gates out.

    ``valid`` (..., J) bool, optional: the blocks inside each clip's true
    output length (the masked meter of zero-padded batches).
    """
    w = w.to(z.dtype)
    weighted = torch.einsum("c,...cj->...j", w, z)
    block_loudness = kw.LOUDNESS_OFFSET + 10.0 * torch.log10(weighted.clamp(min=1e-30))

    def gated_mean(mask):
        m = mask.to(z.dtype)
        count = m.sum(-1)
        z_avg = (z * m[..., None, :]).sum(-1) / count.clamp(min=1.0)[..., None]
        loud = kw.LOUDNESS_OFFSET + 10.0 * torch.log10(
            torch.einsum("c,...c->...", w, z_avg).clamp(min=1e-30)
        )
        return torch.where(count > 0, loud, -torch.inf), count

    abs_mask = block_loudness >= kw.ABSOLUTE_GATE_LUFS
    if valid is not None:
        abs_mask = abs_mask & valid
    abs_loud, abs_count = gated_mean(abs_mask)
    gamma_r = abs_loud + kw.RELATIVE_GATE_LU
    rel_mask = (block_loudness > gamma_r[..., None]) & (block_loudness > kw.ABSOLUTE_GATE_LUFS)
    if valid is not None:
        rel_mask = rel_mask & valid
    loud, count = gated_mean(rel_mask)
    return torch.where((abs_count > 0) & (count > 0), loud, -torch.inf)


def integrated_loudness(
    signal: torch.Tensor, rate: int, weights: Optional[np.ndarray] = None
) -> torch.Tensor:
    """Gated integrated loudness (LUFS) of (n,) mono or (..., C, n)
    multichannel → (...,) float32; −inf when everything is gated out."""
    if signal.dim() == 1:
        signal = signal[None, :]
    if weights is None:
        weights = kw.channel_weights(signal.shape[-2])  # LFE excluded (BS.1770-4)
    w = to_device(np.asarray(weights, dtype=np.float64), signal.device)
    z = block_mean_squares(k_weight(signal, rate), rate)
    if z.shape[-1] == 0:
        return torch.full(signal.shape[:-2], -torch.inf, device=signal.device)
    return gated_loudness_from_blocks(z, w).to(torch.float32)


def _db(x: torch.Tensor) -> torch.Tensor:
    """20·log10(x) in float32, −inf at or below 1e-15 (the reference's rule)."""
    return torch.where(x > 1e-15, 20.0 * torch.log10(x.clamp(min=1e-30)), -torch.inf).to(
        torch.float32
    )


def sample_peak_dbfs(data: torch.Tensor) -> torch.Tensor:
    """Plain sample peak in dBFS per (..., C, n) clip — the reference's
    "true peak" (raytracer_studio.py:695-697)."""
    return _db(data.abs().amax(dim=(-2, -1)))


def rms_dbfs(data: torch.Tensor) -> torch.Tensor:
    """RMS over all samples and channels of each (..., C, n) clip, in dBFS
    (:696-698); the mean square is summed in float64."""
    return _db(data.to(torch.float64).square().mean(dim=(-2, -1)).sqrt())


def _mono(data: torch.Tensor) -> torch.Tensor:
    """The reference meters the mean of the first ≤ 2 channels (:687-688)."""
    return data[..., 0, :] if data.shape[-2] == 1 else data[..., :2, :].mean(dim=-2)


def _lufs(data: torch.Tensor, rate: int, valid_len=None, valid_blocks=None) -> torch.Tensor:
    mono = _mono(data)
    z = block_mean_squares(k_weight(mono, rate), rate, valid_len)[..., None, :]  # one channel
    one = torch.ones(1, dtype=torch.float64, device=data.device)
    if z.shape[-1] == 0:
        lufs = torch.full(mono.shape[:-1], -torch.inf, device=data.device)
    elif valid_blocks is None:
        lufs = gated_loudness_from_blocks(z, one)
    else:
        j = torch.arange(z.shape[-1], device=data.device)
        valid = j < valid_blocks.reshape(valid_blocks.shape + (1,))
        lufs = gated_loudness_from_blocks(z, one, valid)
        lufs = torch.where(valid_blocks > 0, lufs, -torch.inf)
    # silence short-circuits to −inf like the reference (:689)
    return torch.where(mono.abs().amax(-1) < 1e-6, -torch.inf, lufs).to(torch.float32)


def audio_metrics(data: torch.Tensor, rate: int) -> dict:
    """LUFS / sample-peak / RMS of (C, n) or (B, C, n) channels-leading
    audio, with the reference's conventions → dict of (B,)-or-scalar
    float32 tensors."""
    return {
        "lufs": _lufs(data, int(rate)),
        "true_peak_dbfs": sample_peak_dbfs(data),
        "rms_dbfs": rms_dbfs(data),
    }


def audio_metrics_masked(
    data: torch.Tensor, rate: int, valid_len: torch.Tensor, valid_blocks: torch.Tensor
) -> dict:
    """``audio_metrics`` of each clip's ``data[..., :valid_len]`` without
    slicing — one pass over a zero-padded batch.

    ``valid_len``, ``valid_blocks``: int tensors over the leading dims;
    ``valid_blocks = kw.block_count(valid_len, rate)`` comes from the host
    (float64 rounding).  Assumes the tail past valid_len is (near-)zero
    padding: the peak is taken over the full buffer and RMS divides the
    full-buffer energy by valid_len · C.
    """
    channels = data.shape[-2]
    energy = data.to(torch.float64).square().sum(dim=(-2, -1))
    rms = (energy / (valid_len.to(torch.float64) * channels).clamp(min=1.0)).sqrt()
    return {
        "lufs": _lufs(data, int(rate), valid_len, valid_blocks),
        "true_peak_dbfs": sample_peak_dbfs(data),
        "rms_dbfs": _db(rms),
    }


@functools.lru_cache(maxsize=8)
def _polyphase_kernels(factor: int, taps_per_phase: int) -> np.ndarray:
    """(factor, taps) Kaiser-windowed-sinc interpolation bank, per-phase DC gain 1."""
    length = factor * taps_per_phase
    m = np.arange(length) - (length - 1) / 2.0
    h = np.sinc(m / factor) * np.kaiser(length, 10.0)
    phases = np.stack([h[p::factor] for p in range(factor)])
    phases /= phases.sum(axis=1, keepdims=True)
    return phases.astype(np.float32)


def oversampled_true_peak_dbfs(
    data: torch.Tensor, factor: int = 4, taps_per_phase: int = 32
) -> torch.Tensor:
    """Inter-sample true peak of (..., n) via polyphase 4× windowed-sinc
    interpolation (BS.1770 Annex 2), evaluated only where the full tap window
    fits — running off the edge rings against the zero padding."""
    phases = to_device(_polyphase_kernels(factor, taps_per_phase), data.device)
    n = data.shape[-1]
    if n < taps_per_phase:
        data = torch.nn.functional.pad(data, (0, taps_per_phase - n))
        n = taps_per_phase
    valid = max(1, n - taps_per_phase + 1)
    peak = data.abs().amax()
    for p in range(factor):
        acc = torch.zeros(data.shape[:-1] + (valid,), dtype=data.dtype, device=data.device)
        for k in range(taps_per_phase):
            acc = acc + data[..., k : k + valid] * phases[p, k]
        peak = torch.maximum(peak, acc.abs().amax())
    return _db(peak)
