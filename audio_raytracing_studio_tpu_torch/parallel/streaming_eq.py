"""Exact-length circular filters over a long device buffer — port of
``audio_raytracing_studio_tpu/parallel/streaming_eq.py``.

The reference's shelf EQ and air absorption are circular FFT gains at the
exact signal length (raytracer_studio.py:310-336, :392-397).  The streaming
renderer (``parallel.streaming``) holds a whole clip's mix in one
(C, n_total) device buffer whose first ``n0`` samples are the signal, and
filters it here between its chunked passes.

Why not one cuFFT rfft/irfft pair at ``n0``: at a length with large prime
factors (a 30-minute render's 86,490,503 = 11·653·12,041) cuFFT plans the
transform as its own Bluestein and keeps the plan's tables outside PyTorch's
caching allocator — 5.6 GB per plan at that length, 11.2 GB for the pair,
twice that at 60 minutes (NVIDIA H100 80GB HBM3, 700 W; PERF.md), held for
as long as the plan stays in the cache, one pair per distinct length.  So
the transform here is an explicit Bluestein at a power-of-two ``m`` keyed on
the padded buffer length, whose plans hold no such tables:

    u   = x · w⁻                        (time chirp, w± = e^{±iπ(j² mod 2n0)/n0})
    c₁  = IFFT_m(FFT_m(u) · K⁺)          (forward Bluestein convolution)
    u₂  = c₁ · gain                      (the forward post-chirp and the inverse
                                         pre-chirp cancel; gain zero past n0)
    c₂  = conj(IFFT_m(FFT_m(conj u₂) · K⁺))   (the inverse convolution, with
                                         K⁻ = conj-reversed K⁺)
    y   = c₂ · w⁺ / n0

The chirp phases are exact integers ``j² mod 2n0`` (int64), turned into
angles in float64; the chirp and the two convolutions are ``ops.chirp``'s,
which the batched length-dynamic EQ (``ops.filters.apply_shelf_eq_dynamic``)
runs too.  The gains are the single-shot filters' own curves
(``ops.filters``) on the rfft bins, mirrored onto the full spectrum: real and
symmetric under k → n0−k, so a pair of channels runs as one complex stream
L + iR and splits exactly into Re and Im; an odd last channel runs alone.
Positions past ``n0`` come back zero.  The JAX package's four-step
decomposition and its per-length and traced-length executables bounded a
TPU's FFT scratch and are not carried.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chirp, filters
from ..ops.chirp import fft_length_for as bluestein_length  # the power of two ≥ 2·n − 1
from ..ops.ir_synth import to_device

MAX_N0 = 1 << 30  # the JAX package's limit, kept so that both refuse the same lengths


def _full_spectrum(half: torch.Tensor, n0: int) -> torch.Tensor:
    """A gain on the n0//2 + 1 rfft bins → the same gain on all n0 bins
    (k and n0 − k share a value), the circular filter ``irfft(rfft · half)``
    computes."""
    n_half = half.shape[-1]
    return torch.cat([half, half[1 : n0 - n_half + 1].flip(0)])


def _exact_length(buf_cn: torch.Tensor, n0: int, half_gain: torch.Tensor) -> torch.Tensor:
    """The circular filter of ``half_gain`` (its rfft-bin curve at n0) over
    ``buf_cn[:, :n0]``, a pair of channels per complex stream; zeros past
    ``n0``."""
    c_count, n_total = int(buf_cn.shape[0]), int(buf_cn.shape[1])
    n_copy = min(n0, n_total)
    m = bluestein_length(max(n0, n_total))
    w_plus = chirp._chirp(torch.arange(n0, dtype=torch.int64, device=buf_cn.device), n0, +1.0)
    k_plus = chirp.kernel_spectrum(w_plus, m)
    gain = _full_spectrum(half_gain, n0)
    out = torch.zeros_like(buf_cn)
    for ch in range(0, c_count, 2):
        pair = ch + 1 < c_count
        z = torch.zeros(n0, dtype=torch.complex64, device=buf_cn.device)
        z.real[:n_copy] = buf_cn[ch, :n_copy]
        if pair:
            z.imag[:n_copy] = buf_cn[ch + 1, :n_copy]
        y = chirp.bluestein_filter(z, gain, w_plus, k_plus, n0)
        out[ch, :n_copy] = y.real[:n_copy]
        if pair:
            out[ch + 1, :n_copy] = y.imag[:n_copy]
    return out


def _gain_tensor(value, device) -> torch.Tensor:
    """A scalar or (1,) gain → a (1,) float32 tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(1)
    return to_device(np.asarray([value], np.float32), device)


def air_absorption_streaming(buf_cn: torch.Tensor, n0: int, rate: int, factor) -> torch.Tensor:
    """Exact-length circular air absorption of a (C, n_total) buffer whose
    signal occupies ``[0, n0)`` → a new (C, n_total) buffer, zero past ``n0``.

    Equal to ``ops.filters.apply_air_absorption`` at length ``n0`` to float32
    round-off; ``factor`` is a float or a (1,) tensor.
    """
    if n0 < 2:
        return buf_cn
    if n0 >= MAX_N0:
        raise ValueError("exact streaming air absorption supports n0 < 2^30")
    fac = _gain_tensor(factor, buf_cn.device)
    return _exact_length(buf_cn, n0, filters.air_absorption_gain(n0, int(rate), fac)[0])


def shelf_eq_streaming(
    buf_cn: torch.Tensor, n0: int, rate: int, bass_gain, treble_gain
) -> torch.Tensor:
    """Exact-length circular shelf EQ of a (C, n_total) buffer whose signal
    occupies ``[0, n0)`` → a new (C, n_total) buffer, zero past ``n0``.

    Equal to ``ops.filters.apply_shelf_eq`` at length ``n0`` to float32
    round-off; the gains are floats or (1,) tensors.
    """
    if n0 < 2:
        return buf_cn
    if n0 >= MAX_N0:
        raise ValueError("exact streaming EQ supports n0 < 2^30")
    bg = _gain_tensor(bass_gain, buf_cn.device)
    tg = _gain_tensor(treble_gain, buf_cn.device)
    return _exact_length(buf_cn, n0, filters.shelf_eq_gain(n0, int(rate), bg, tg)[0])
