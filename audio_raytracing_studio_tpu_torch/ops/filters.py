"""Frequency-domain filters — port of ``audio_raytracing_studio_tpu/ops/filters.py``.

Air-absorption tilt and shelf EQ are *circular* FFT-domain gain curves at
the exact signal length — the reference's definition
(raytracer_studio.py:310-336, :387-398), so the transform length is
parity-bearing.  Each filter is one ``rfft(x, n)`` · gain · ``irfft(·, n)``
at the exact n (cuFFT takes any n; the JAX package's Bluestein and
affine-wrap forms compute the same circular filter).  Gain curves are
built on the signal's device in float64 from the static (n, rate) grid —
``np.fft.rfftfreq``'s arithmetic, so the masks' edge bins fall where the
reference's do — and nothing of them is kept between calls; the user
gains are per-clip (B,) tensors.

A zero-padded batch of clips with mixed true lengths is EQ'd by
``apply_shelf_eq_dynamic``: a Bluestein at the power of two of the padded
length (``ops.chirp``), with each clip's true length and band edges as
per-row scalars, so the cuFFT plans it creates depend on the padded length
alone.  ``apply_shelf_eq_padded`` computes the same function with one exact
transform pair per distinct true length; it is the plain version the tests
hold the dynamic EQ to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from . import chirp
from .ir_synth import to_device

# Rows per pass of the length-dynamic EQ.  Fixed, because cuFFT keys its
# plans on the batch count as well as the length: a batch of B rows makes
# plans for EQ_DYN_ROWS rows and for B mod EQ_DYN_ROWS, whatever the true
# lengths.  It also bounds the working set: at m = 2^23 each row holds about
# five complex64 streams of 64 MiB.
EQ_DYN_ROWS = 4


def _rfft_freqs(n: int, rate: int, device) -> torch.Tensor:
    """``np.fft.rfftfreq(n, d=1/rate)`` in float64 on ``device``, bit for bit
    (the same integer bins times the same spacing, one IEEE product each)."""
    val = 1.0 / (n * (1.0 / rate))
    return torch.arange(n // 2 + 1, dtype=torch.float64, device=device) * val


def _air_ramp(n: int, rate: int, device) -> torch.Tensor:
    """Static air-absorption ramp per rfft bin, float64 arithmetic → float32:
    0 below the 2 kHz start, rising linearly to 1 at Nyquist."""
    freqs = _rfft_freqs(n, rate, device)
    start = config.AIR_ABSORPTION_START_HZ
    max_freq = (n // 2) * (1.0 / (n * (1.0 / rate)))  # freqs[-1], without a device read
    if max_freq <= start:
        return torch.zeros(freqs.shape, dtype=torch.float32, device=device)
    ramp = ((freqs - start) / (max_freq - start)).clamp(0.0, 1.0)
    return torch.where(freqs >= start, ramp, 0.0).to(torch.float32)


def _shelf_masks(n: int, rate: int, device):
    """Static shelf bin masks: bass (0, 250] Hz, treble [4 kHz, ∞)."""
    freqs = _rfft_freqs(n, rate, device)
    bass = (freqs > 1e-6) & (freqs <= config.EQ_BASS_CUTOFF_HZ)
    return bass, freqs >= config.EQ_TREBLE_CUTOFF_HZ


def _circular_gain(signal: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Circular filter over the last axis at its exact length n.

    signal (B, ..., n); gain (B, n//2+1) real, broadcast over the middle dims.
    """
    n = signal.shape[-1]
    gain = gain.reshape(gain.shape[0], *([1] * (signal.dim() - 2)), gain.shape[-1])
    return torch.fft.irfft(torch.fft.rfft(signal, n=n) * gain, n=n)


def air_absorption_gain(n_fft: int, rate: int, factor: torch.Tensor) -> torch.Tensor:
    """Per-bin gain (B, F): 1.0 below 2 kHz, ramping to 1−0.8·factor at Nyquist."""
    ramp = _air_ramp(n_fft, rate, factor.device)
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
    bass_mask, treble_mask = _shelf_masks(n_fft, rate, bass_gain.device)
    lo, hi = config.EQ_GAIN_CLIP
    gain = torch.where(bass_mask[None, :], bass_gain.clamp(lo, hi)[:, None], 1.0)
    return torch.where(treble_mask[None, :], treble_gain.clamp(lo, hi)[:, None], gain)


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


def apply_shelf_eq_padded(
    signal: torch.Tensor,
    rate: int,
    bass_gain: torch.Tensor,
    treble_gain: torch.Tensor,
    lengths,
) -> torch.Tensor:
    """Shelf EQ of zero-padded clips, each at its TRUE length — the plain
    version of ``apply_shelf_eq_dynamic``, one exact-length call per
    distinct true length (on a card, one cuFFT plan pair each).

    signal (B, C, L); ``lengths``: per-clip true lengths n0 ≤ L (host ints).
    The circular EQ is parity-bearing at the true length (its brick-wall
    masks ring over the whole circle), so clip b is filtered on
    ``signal[b, :, :n0]`` at length n0 and is zero past it.  Clips with the
    same n0 share one call.
    """
    out = torch.zeros_like(signal)
    lengths = [int(n0) for n0 in lengths]
    for n0 in sorted(set(lengths)):
        idx = to_device(
            np.asarray([b for b, m in enumerate(lengths) if m == n0], np.int64), signal.device
        )
        out[idx, :, :n0] = apply_shelf_eq(
            signal[idx, :, :n0], rate, bass_gain[idx], treble_gain[idx]
        )
    return out


class EQDyn(NamedTuple):
    """Per-clip scalars of the length-dynamic exact shelf EQ: ``n0`` the
    clip's true circular length, and the band edges ``k_lo``, ``k_bass``,
    ``k_treble`` from the host float64 rfftfreq arithmetic
    (``chirp.band_edges``, whose edge bins carry rfftfreq's float dust).
    Each field holds a host int per row, or is a (B,) int64 tensor."""

    n0: object
    k_lo: object
    k_bass: object
    k_treble: object

    @classmethod
    def stack(cls, rows, device) -> "EQDyn":
        """Per-clip host rows (``eq_dyn_host``) → one EQDyn of (B,) int64
        tensors on ``device``, uploaded together as one (4, B) table."""
        table = np.ascontiguousarray(np.asarray(rows, np.int64).reshape(-1, 4).T)
        return cls(*to_device(table, device))


def eq_dyn_host(n0: int, rate: int) -> EQDyn:
    """Host-side constructor: float64 band edges for one true length."""
    return EQDyn(int(n0), *chirp.band_edges(int(n0), int(rate)))


def apply_shelf_eq_dynamic(
    signal: torch.Tensor,
    bass_gain: torch.Tensor,
    treble_gain: torch.Tensor,
    dyn: EQDyn,
) -> torch.Tensor:
    """Exact circular shelf EQ of each row of a zero-padded (B, C, L) batch
    at its own true length ``dyn.n0[b]`` ≤ L → (B, C, L) float32, zero past
    each row's n0.  The gains are (B,) tensors.

    Equal to ``apply_shelf_eq`` on ``signal[b, :, :n0]`` at length n0 (and
    to ``apply_shelf_eq_padded``) to float32 round-off.  Every FFT runs at
    m = ``chirp.fft_length_for(L)`` (≥ 2·n0 − 1 for every n0 ≤ L) over
    ``EQ_DYN_ROWS`` rows, so the transforms' shapes — and so the cuFFT plans
    — depend on (B, L) alone, never on the true lengths.  The chirps and the
    gain derive on the device from the per-row n0 and band edges
    (``ops.chirp``); a pair of channels runs as one complex stream L + iR
    (the filter's impulse response is real) and an odd last channel alone.
    """
    batch, c_count, length = signal.shape
    device = signal.device
    if not isinstance(dyn.n0, torch.Tensor):
        dyn = EQDyn.stack(list(zip(*dyn)), device)
    m = chirp.fft_length_for(length)
    j = torch.arange(length, dtype=torch.int64, device=device)
    out = torch.empty_like(signal)
    for start in range(0, batch, EQ_DYN_ROWS):
        rows = slice(start, start + EQ_DYN_ROWS)
        n0, k_lo, k_bass, k_treble = (f[rows, None] for f in dyn)
        w_plus = chirp._chirp(j, n0, +1.0).masked_fill_(j >= n0, 0.0)
        k_plus = chirp.kernel_spectrum(w_plus, m)
        gain = chirp.shelf_gain_from_edges(j, n0, k_lo, k_bass, k_treble,
                                           bass_gain[rows, None], treble_gain[rows, None])
        for ch in range(0, c_count, 2):
            pair = ch + 1 < c_count
            x = signal[rows, ch]
            z = torch.complex(x, signal[rows, ch + 1]) if pair else x.to(torch.complex64)
            y = chirp.bluestein_filter(z, gain, w_plus, k_plus, n0)
            out[rows, ch] = y.real
            if pair:
                out[rows, ch + 1] = y.imag
    return out


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
