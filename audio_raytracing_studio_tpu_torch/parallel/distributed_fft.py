"""Distributed exact-length DFT and shelf EQ over the block-sharded sample
axis — port of ``audio_raytracing_studio_tpu/parallel/distributed_fft.py``.

The reference's shelf EQ is a circular FFT gain at the *exact* signal length
(raytracer_studio.py:392-397); moving the transform length even by a few
samples moves the brick-wall cutoff bins.  In long-render mode the signal's
sample axis is sharded over the mesh's "block" axis, so the exact transform
is distributed:

1. **Four-step FFT** at m = 2^a = D·B_m over blocks: a D-point DFT across
   shards (a D-step ``ppermute`` ring), the twiddle ``exp(-2πi·c·j/m)``,
   then a local power-of-two FFT per shard.  The output lands bin-strided
   (shard c holds bins ≡ c mod D); the inverse runs the steps backwards.
2. **Bluestein** wraps the exact length n0 into that power-of-two circular
   convolution: ``X = w ⊙ IFFT_m(FFT_m(x⊙w) ⊙ B)``.  The chirp phases
   ``k² mod 2n0`` are exact int64 residues turned into angles in float64,
   each shard deriving its share of every constant from its global indices.
3. **Block alignment**: the long renderer picks block_len = m/(2D), so each
   m-layout block is exactly two renderer blocks — the reshard between the
   signal layout and the FFT layout is two static ``ppermute``s each way.

Per-shard memory stays flat in the clip length (O(m/D)).

The JAX package computes the residues with int32 modular doubling (its TPU
has no int64) and the angles in float32; int64 holds ``k²`` exactly for
k < 2^30 and float64 angles are closer to the true chirp, so the values of
``_modsq`` are the same and the transforms agree to float32 round-off.
The chirp arithmetic, the band edges and the shelf gain come from the
port's ``ops/chirp.py``, as the JAX module takes them from its own.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..ops.chirp import (  # noqa: F401  (_modsq, shelf_gain_at_bins: re-exported as the JAX module does)
    _chirp,
    _modsq,
    band_edges,
    chirp_kernel_at_bins,
    fft_length_for,
    shelf_gain_at_bins,
    shelf_gain_from_edges,
)
from . import mesh as meshlib
from .streaming_eq import MAX_N0


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def block_len_for(n0: int, num_blocks: int) -> int:
    """The renderer block length that aligns with the EQ's FFT layout."""
    return fft_length_for(n0) // (2 * num_blocks)


def _indices(axis: meshlib.Axis, c: int, length: int) -> torch.Tensor:
    """Shard c's global indices c·length … (c+1)·length − 1, int64, on its device."""
    return torch.arange(c * length, (c + 1) * length, dtype=torch.int64,
                        device=axis.devices[c])


# --------------------------------------------------------------------------
# Four-step distributed FFT at m = D·B_m (power of two), block ↔ strided.
# --------------------------------------------------------------------------


def _ring_dft(axis: meshlib.Axis, xs: List[torch.Tensor], sign: float) -> List[torch.Tensor]:
    """On shard c: Σ_d x_d · exp(sign·2πi·c·d/D), by a D-step ppermute ring
    (one block circulates per step: flat memory, neighbour hops only)."""
    d_count = axis.size
    shards = range(d_count)
    acc = axis.map(torch.zeros_like, xs)
    buf = list(xs)
    for step in range(d_count):
        def add(c, a, b):
            src = (c - step) % d_count  # whose block ``b`` is
            angle = sign * 2.0 * math.pi * ((c * src) % d_count) / d_count
            return a + b * complex(math.cos(angle), math.sin(angle))

        acc = axis.map(add, shards, acc, buf)
        if step < d_count - 1:
            buf = meshlib.ppermute(axis, buf, meshlib.ring(axis))
    return acc


def _twiddle(axis: meshlib.Axis, c: int, length: int, m: int, sign: float) -> torch.Tensor:
    """exp(sign·2πi·c·j/m) for j ∈ [0, length), on shard c (c·j < m exact)."""
    cj = torch.arange(length, dtype=torch.int64, device=axis.devices[c]) * c
    angle = cj.to(torch.float64) * (sign * 2.0 * math.pi / m)
    return torch.complex(torch.cos(angle).float(), torch.sin(angle).float())


def dist_fft(axis: meshlib.Axis, x_blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """FFT_m of a block-sharded (..., B_m) complex array → bin-strided shards:
    shard c returns X[c + D·t] for t ∈ [0, B_m).  m = D·B_m must be a power
    of two."""
    b_m = x_blocks[0].shape[-1]
    m = axis.size * b_m
    s = _ring_dft(axis, x_blocks, sign=-1.0)
    return axis.map(lambda c, v: torch.fft.fft(v * _twiddle(axis, c, b_m, m, -1.0), dim=-1),
                    range(axis.size), s)


def dist_ifft(axis: meshlib.Axis, x_strided: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of ``dist_fft``: strided shards → block-sharded, 1/m applied."""
    b_m = x_strided[0].shape[-1]
    m = axis.size * b_m
    t = axis.map(lambda c, v: torch.fft.ifft(v, dim=-1) * _twiddle(axis, c, b_m, m, +1.0),
                 range(axis.size), x_strided)
    return axis.map(lambda v: v / axis.size, _ring_dft(axis, t, sign=+1.0))


# --------------------------------------------------------------------------
# Layout reshard: renderer blocks (B_sig = m/2D) ↔ FFT blocks (B_m = 2·B_sig).
# --------------------------------------------------------------------------


def _to_fft_layout(axis: meshlib.Axis, u: List[torch.Tensor]) -> List[torch.Tensor]:
    """(..., B_sig) renderer blocks → (..., 2·B_sig) m-layout blocks.

    The global m-array is the m/2-sample signal followed by zeros, so FFT
    block d = [signal block 2d | signal block 2d+1] (zeros for 2d ≥ D).
    """
    d_count = axis.size
    even = [(2 * t, t) for t in range(d_count) if 2 * t < d_count]
    odd = [(2 * t + 1, t) for t in range(d_count) if 2 * t + 1 < d_count]
    first = meshlib.ppermute(axis, u, even)
    second = meshlib.ppermute(axis, u, odd)
    return axis.map(lambda a, b: torch.cat([a, b], dim=-1), first, second)


def _from_fft_layout(axis: meshlib.Axis, y: List[torch.Tensor]) -> List[torch.Tensor]:
    """(..., 2·B_sig) m-layout blocks → (..., B_sig) renderer blocks."""
    d_count = axis.size
    b_sig = y[0].shape[-1] // 2
    even = [(t, 2 * t) for t in range(d_count) if 2 * t < d_count]
    odd = [(t, 2 * t + 1) for t in range(d_count) if 2 * t + 1 < d_count]
    a = meshlib.ppermute(axis, [v[..., :b_sig] for v in y], even)
    b = meshlib.ppermute(axis, [v[..., b_sig:] for v in y], odd)
    return axis.map(torch.add, a, b)


# --------------------------------------------------------------------------
# Distributed Bluestein DFT at exact length n0 (renderer-block layout).
# --------------------------------------------------------------------------


def _chirp_kernel(axis: meshlib.Axis, n0: int, m: int, sign: float) -> List[torch.Tensor]:
    """The chirp kernel's shards, each built on its shard from global indices."""
    b_m = m // axis.size
    return axis.map(lambda c: chirp_kernel_at_bins(_indices(axis, c, b_m), n0, m, sign),
                    range(axis.size))


def _chirp_kernel_spectrum(axis: meshlib.Axis, n0: int, m: int, sign: float):
    """B = FFT_m(chirp kernel), bin-strided."""
    return dist_fft(axis, _chirp_kernel(axis, n0, m, sign))


def dist_dft_exact(axis: meshlib.Axis, x_blocks: List[torch.Tensor], n0: int,
                   inverse: bool = False, kernel_spectrum=None) -> List[torch.Tensor]:
    """Exact length-n0 (i)DFT of a block-sharded (..., B_sig) array.

    Requires B_sig = m/(2·D) (``block_len_for``) so the layouts align.
    Positions ≥ n0 of the input are ignored; output positions ≥ n0 are zero.
    The inverse includes the 1/n0 normalization.  ``kernel_spectrum``, when
    given, is a precomputed ``_chirp_kernel_spectrum(axis, n0, m, sign)``
    (a forward + inverse pair batches both kernel FFTs into one distributed
    transform — ``shelf_eq_sharded``).
    """
    b_sig = x_blocks[0].shape[-1]
    m = 2 * axis.size * b_sig
    if m != fft_length_for(n0):
        raise ValueError(
            f"block length {b_sig} does not align with the exact-DFT layout "
            f"for n0={n0}: need block_len_for(n0, D) = {block_len_for(n0, axis.size)}"
        )
    if n0 >= MAX_N0:
        raise ValueError("exact distributed DFT supports n0 < 2^30")
    sign = +1.0 if inverse else -1.0

    def chirp(c):
        j = _indices(axis, c, b_sig)  # global signal index
        valid = j < n0
        w = _chirp(torch.where(valid, j, torch.zeros_like(j)), n0, sign)
        return torch.where(valid, w, torch.zeros_like(w))

    ws = axis.map(chirp, range(axis.size))
    u = axis.map(lambda x, w: x.to(torch.complex64) * w, x_blocks, ws)
    spec = dist_fft(axis, _to_fft_layout(axis, u))
    if kernel_spectrum is None:
        kernel_spectrum = _chirp_kernel_spectrum(axis, n0, m, sign)
    spec = axis.map(torch.mul, spec, kernel_spectrum)
    conv = _from_fft_layout(axis, dist_ifft(axis, spec))
    return axis.map(lambda y, w: y * w / n0 if inverse else y * w, conv, ws)


# --------------------------------------------------------------------------
# Sharded exact shelf EQ (the long-render stage).
# --------------------------------------------------------------------------


def shelf_eq_sharded(axis: meshlib.Axis, x_blocks: List[torch.Tensor], rate: int,
                     bass_gain, treble_gain, n0: int) -> List[torch.Tensor]:
    """Exact-length circular shelf EQ of a block-sharded real signal.

    Matches ``ops.filters.apply_shelf_eq`` at length n0 (raytracer_studio.py:
    392-397): bass gain on (0, 250] Hz, treble on [4 kHz, ∞), the treble
    mask winning where both hold, over the two-sided spectrum, with band
    edges equal to the single-device rfftfreq masks (``band_edges``).  Each
    gain is a float or a list of per-shard tensors that broadcast over the
    blocks.
    """
    if not is_power_of_two(axis.size):
        raise ValueError("shelf_eq_sharded requires a power-of-two block axis")
    b_sig = x_blocks[0].shape[-1]
    m = 2 * axis.size * b_sig
    shards = range(axis.size)
    # both chirp-kernel spectra (forward and inverse) in one batched
    # distributed FFT: they are data-independent, only the sign differs
    kernels = axis.map(lambda f, i: torch.stack([f, i]),
                       _chirp_kernel(axis, n0, m, sign=-1.0),
                       _chirp_kernel(axis, n0, m, sign=+1.0))
    kspec = dist_fft(axis, kernels)
    spec = dist_dft_exact(axis, x_blocks, n0, inverse=False,
                          kernel_spectrum=[k[0] for k in kspec])
    edges = band_edges(n0, rate)
    per_shard = [g if isinstance(g, list) else [g] * axis.size
                 for g in (bass_gain, treble_gain)]
    # bins ≥ n0 multiply by 0: dist_dft_exact already zeroed them
    spec = axis.map(
        lambda c, s, bg, tg: s * shelf_gain_from_edges(_indices(axis, c, b_sig), n0, *edges,
                                                       bg, tg),
        shards, spec, *per_shard)
    y = dist_dft_exact(axis, spec, n0, inverse=True, kernel_spectrum=[k[1] for k in kspec])

    def real_part(c, v):
        real = v.real.to(torch.float32)
        return torch.where(_indices(axis, c, b_sig) < n0, real, torch.zeros_like(real))

    return axis.map(real_part, shards, y)
