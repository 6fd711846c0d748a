"""Frequency-domain filters — port of ``audio_raytracing_studio_tpu/ops/filters.py``.

Air-absorption tilt and shelf EQ are *circular* FFT-domain gain curves at
the exact signal length — the reference's definition
(raytracer_studio.py:310-336, :387-398), so the transform length is
parity-bearing.  Each filter is one ``rfft(x, n)`` · gain · ``irfft(·, n)``
at the exact n (cuFFT takes any n; the JAX package's Bluestein and
affine-wrap forms compute the same circular filter).  Gain curves are
built on the host in float64 from the static (n, rate) grid; the user
gains are per-clip (B,) tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_raytracing_studio_tpu import config


def _air_ramp_np(n: int, rate: int) -> np.ndarray:
    """Static air-absorption ramp per rfft bin (host float64): 0 below the
    2 kHz start, rising linearly to 1 at Nyquist."""
    freqs = np.fft.rfftfreq(n, d=1.0 / rate)
    start = config.AIR_ABSORPTION_START_HZ
    max_freq = freqs[-1] if len(freqs) > 0 else start + 1
    if max_freq > start:
        ramp = np.clip((freqs - start) / (max_freq - start), 0.0, 1.0)
        return np.where(freqs >= start, ramp, 0.0)
    return np.zeros_like(freqs)


def _bass_mask_np(n: int, rate: int) -> np.ndarray:
    """Static bass-shelf bin mask (host float64): (0, 250] Hz."""
    freqs = np.fft.rfftfreq(n, d=1.0 / rate)
    return ((freqs > 1e-6) & (freqs <= config.EQ_BASS_CUTOFF_HZ)).astype(np.float64)


def _treble_mask_np(n: int, rate: int) -> np.ndarray:
    """Static treble-shelf bin mask (host float64): [4 kHz, ∞)."""
    freqs = np.fft.rfftfreq(n, d=1.0 / rate)
    return (freqs >= config.EQ_TREBLE_CUTOFF_HZ).astype(np.float64)


@functools.lru_cache(maxsize=8)
def _curve(name: str, n: int, rate: int) -> np.ndarray:
    """float32 copy of one static curve, cached read-only per (n, rate)."""
    fn = {"air_ramp": _air_ramp_np, "bass": _bass_mask_np, "treble": _treble_mask_np}[name]
    curve = fn(n, rate).astype(np.float32)
    curve.flags.writeable = False
    return curve


def _curve_tensor(name: str, n: int, rate: int, device) -> torch.Tensor:
    return torch.from_numpy(_curve(name, n, rate).copy()).to(device)


def _circular_gain(signal: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Circular filter over the last axis at its exact length n.

    signal (B, ..., n); gain (B, n//2+1) real, broadcast over the middle dims.
    """
    n = signal.shape[-1]
    gain = gain.reshape(gain.shape[0], *([1] * (signal.dim() - 2)), gain.shape[-1])
    return torch.fft.irfft(torch.fft.rfft(signal, n=n) * gain, n=n)


def air_absorption_gain(n_fft: int, rate: int, factor: torch.Tensor) -> torch.Tensor:
    """Per-bin gain (B, F): 1.0 below 2 kHz, ramping to 1−0.8·factor at Nyquist."""
    ramp = _curve_tensor("air_ramp", n_fft, rate, factor.device)
    max_damping = factor.clamp(0.0, 1.0) * config.AIR_ABSORPTION_MAX_DAMPING
    return 1.0 - ramp[None, :] * max_damping[:, None]


def apply_air_absorption(
    signal: torch.Tensor, rate: int, factor: torch.Tensor
) -> torch.Tensor:
    """Air-absorption low-pass over the last axis (length = FFT length).

    signal (B, ..., n) float32; factor (B,).  The caller decides statically
    whether to apply it (the reference skips when factor < 0.01, :312).
    """
    n = signal.shape[-1]
    if n < 2:
        return signal
    return _circular_gain(signal, air_absorption_gain(n, rate, factor))


def shelf_eq_gain(
    n_fft: int, rate: int, bass_gain: torch.Tensor, treble_gain: torch.Tensor
) -> torch.Tensor:
    """Per-bin gain (B, F): bass on (0, 250] Hz, treble on [4 kHz, ∞)."""
    device = bass_gain.device
    bass_mask = _curve_tensor("bass", n_fft, rate, device).bool()[None, :]
    treble_mask = _curve_tensor("treble", n_fft, rate, device).bool()[None, :]
    lo, hi = config.EQ_GAIN_CLIP
    gain = torch.where(bass_mask, bass_gain.clamp(lo, hi)[:, None], 1.0)
    return torch.where(treble_mask, treble_gain.clamp(lo, hi)[:, None], gain)


def apply_shelf_eq(
    signal: torch.Tensor,
    rate: int,
    bass_gain: torch.Tensor,
    treble_gain: torch.Tensor,
) -> torch.Tensor:
    """Shelf EQ over the last axis at the exact signal length.

    The caller statically skips this when both gains are ≈1 (ref :389).
    """
    n = signal.shape[-1]
    if n < 2:
        return signal
    return _circular_gain(signal, shelf_eq_gain(n, rate, bass_gain, treble_gain))


def conditional_peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rescale each clip only if its |x|max > 1; zero out sub-1e-9 residue.

    The reference's data-dependent normalization branches
    (raytracer_studio.py:402-404, :457, :497-499, :558-560).  x is
    (B, C, N); the reduction runs per clip over (C, N) — never across the
    batch — as the JAX version does under vmap.
    """
    max_val = x.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(max_val > 1.0, 1.0 / max_val, 1.0)
    return torch.where(max_val < 1e-9, 0.0, x * scale)
