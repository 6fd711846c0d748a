"""Exact Bluestein chirps, the shelf gain's bin semantics and the Bluestein
filter core — port of ``audio_raytracing_studio_tpu/ops/chirp.py``.

The one definition of the pieces every exact-length shelf EQ of the port
shares: the length-dynamic batched EQ (``ops.filters.apply_shelf_eq_dynamic``),
the streaming renderer's filters (``parallel.streaming_eq``) and the
distributed EQ (``parallel.distributed_fft``).

* **Chirp phases** ``exp(±iπ·j²/n0)`` with the phase reduced exactly mod 2π:
  ``j² mod 2n0`` is an exact int64 residue (``j² < 2^60`` for ``j < 2^30``),
  turned into an angle in float64.  ``n0`` may be a Python int or a per-row
  int64 tensor of shape (R, 1) that broadcasts against the indices.  The JAX
  package reduces in uint32 modular doubling (its TPU has no int64) and
  takes the angle in float32: the residues are equal, the chirps agree to
  float32 round-off.
* **Kernel layout** (``chirp_kernel_at_bins``, ``kernel_spectrum``):
  K[k] = w̄[k] for k < n0, K[m−k] = w̄[k] for 1 ≤ k < n0, else 0.
* **Shelf edge bins** (``band_edges`` + ``shelf_gain_from_edges``): the
  reference's masks come from ``np.fft.rfftfreq``'s float64 arithmetic
  (raytracer_studio.py:392-397), and a bin can land exactly on a cutoff
  with float dust, so the edges are derived on the host in float64.
* **The filter** (``bluestein_filter``): a circular filter at n0 as two
  power-of-two convolutions of length m ≥ 2·n0 − 1 with the gain between
  them, so the FFT plans depend on m alone, never on n0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config


def fft_length_for(n0: int) -> int:
    """Bluestein convolution length: the next power of two ≥ 2·n0 − 1."""
    return 1 << max(0, 2 * int(n0) - 2).bit_length()


def _modsq(j: torch.Tensor, modulus) -> torch.Tensor:
    """(j² mod modulus) for int j ∈ [0, 2^30) — exact in int64 (j² < 2^60).
    ``modulus`` is a Python int or an int64 tensor that broadcasts against j."""
    j = j.to(torch.int64)
    sq = j * j
    if isinstance(modulus, torch.Tensor):
        return sq.remainder(modulus)
    return sq.remainder_(int(modulus))


def _chirp(j: torch.Tensor, n0, sign: float) -> torch.Tensor:
    """exp(sign·iπ·j²/n0) with the phase reduced exactly mod 2π → complex64.

    ``j`` int indices (values outside [0, n0) give a value callers mask);
    ``n0`` a Python int or an int64 tensor broadcasting against ``j``."""
    angle = _modsq(j, 2 * n0).to(torch.float64)
    if isinstance(n0, torch.Tensor):
        angle = angle.mul_((sign * math.pi) / n0.to(torch.float64))
    else:
        angle = angle.mul_(sign * math.pi / n0)
    return torch.complex(torch.cos(angle).float(), torch.sin(angle).float())


def chirp_kernel_at_bins(k: torch.Tensor, n0, m: int, sign: float) -> torch.Tensor:
    """Bluestein time-domain chirp kernel at global m-indices ``k``:
    K[k] = w̄[k] (k < n0), K[m−k] = w̄[k] (1 ≤ k < n0), else 0."""
    head = k < n0
    tail = k > m - n0  # the mirror region; maps to w̄[m−k]
    idx = torch.where(head, k, torch.where(tail, m - k, torch.zeros_like(k)))
    wbar = _chirp(idx, n0, sign=-sign)  # conj of the length-n0 chirp
    return torch.where(head | tail, wbar, torch.zeros_like(wbar))


def band_edges(n0: int, rate: int):
    """(k_lo, k_bass, k_treble): bass bins are [k_lo, k_bass], treble bins
    start at k_treble — replicating ``np.fft.rfftfreq``'s float64 arithmetic
    bit for bit, since a bin can land exactly on a cutoff with float dust
    (250.00000000000003 Hz at 44.1 kHz) where an integer floor / ceil of
    cutoff·n0/rate disagrees with the single-device masks (host code)."""
    val = 1.0 / (n0 * (1.0 / rate))  # rfftfreq(n0, d=1/rate) bin spacing
    half = n0 // 2
    bass_hz = float(config.EQ_BASS_CUTOFF_HZ)
    treble_hz = float(config.EQ_TREBLE_CUTOFF_HZ)

    k_lo = 0  # smallest bin with freq > 1e-6 (the bass mask's DC exclusion)
    while k_lo <= half and k_lo * val <= 1e-6:
        k_lo += 1
    k_bass = min(int(np.floor(bass_hz * n0 / rate)) + 2, half)
    while k_bass >= 0 and k_bass * val > bass_hz:
        k_bass -= 1
    k_treble = max(int(np.ceil(treble_hz * n0 / rate)) - 2, 0)
    while k_treble <= half and k_treble * val < treble_hz:
        k_treble += 1
    return k_lo, k_bass, k_treble


def shelf_gain_from_edges(k: torch.Tensor, n0, k_lo, k_bass, k_treble,
                          bass_gain, treble_gain) -> torch.Tensor:
    """Two-sided shelf gain at bin indices ``k`` (0 outside [0, n0); in-band
    bins outside both masks 1); the treble mask wins where both hold.
    ``n0`` and the edges are ints or int64 tensors, the gains floats or
    float tensors, each broadcasting against ``k``."""
    in_band = k < n0
    bass_mask = in_band & (((k >= k_lo) & (k <= k_bass)) | ((k >= n0 - k_bass) & (k <= n0 - k_lo)))
    treble_mask = in_band & (k >= k_treble) & (k <= n0 - k_treble)
    lo, hi = config.EQ_GAIN_CLIP
    as_t = lambda g: torch.as_tensor(g, dtype=torch.float32, device=k.device)  # noqa: E731
    one = torch.ones((), dtype=torch.float32, device=k.device)
    gain = torch.where(bass_mask, as_t(bass_gain).clamp(lo, hi), one)
    gain = torch.where(treble_mask, as_t(treble_gain).clamp(lo, hi), gain)
    return torch.where(in_band, gain, torch.zeros_like(gain)).to(torch.float32)


def shelf_gain_at_bins(k: torch.Tensor, n0: int, rate: int, bass_gain,
                       treble_gain) -> torch.Tensor:
    """Static-n0 convenience: host band edges + ``shelf_gain_from_edges``."""
    return shelf_gain_from_edges(k, n0, *band_edges(n0, rate), bass_gain, treble_gain)


def kernel_spectrum(w_plus: torch.Tensor, m: int) -> torch.Tensor:
    """K⁺ = FFT_m over the last axis of the even chirp kernel: w⁺[d] at d
    and at m − d.  ``w_plus`` (..., n) is zero past each row's n0 ≤ n, and
    2·n − 1 ≤ m, so the two halves never overlap."""
    n = w_plus.shape[-1]
    kernel = torch.zeros(*w_plus.shape[:-1], m, dtype=torch.complex64, device=w_plus.device)
    kernel[..., :n] = w_plus
    if n > 1:
        kernel[..., m - n + 1:] = w_plus[..., 1:].flip(-1)
    return torch.fft.fft(kernel)


def bluestein_filter(z: torch.Tensor, gain: torch.Tensor, w_plus: torch.Tensor,
                     k_plus: torch.Tensor, n0) -> torch.Tensor:
    """The circular filter of a real, k → n0−k symmetric ``gain`` at length
    n0 over complex streams ``z`` (..., n) → (..., n) complex64, zero past n0.

    ``gain`` and ``w_plus`` (..., n) are zero past each row's n0 (int, or an
    int64 tensor broadcasting against the rows); ``k_plus`` (..., m) from
    ``kernel_spectrum``.  With w± = e^{±iπ(j² mod 2n0)/n0}:

        c₁ = IFFT_m(FFT_m(z · w⁻) · K⁺)            the forward Bluestein
        c₂ = conj(IFFT_m(FFT_m(conj(c₁ · gain)) · K⁺))   the inverse, K⁻ = conj-reversed K⁺
        y  = c₂ · w⁺ / n0

    (the forward post-chirp and the inverse pre-chirp cancel)."""
    n, m = z.shape[-1], k_plus.shape[-1]
    u = torch.zeros(*z.shape[:-1], m, dtype=torch.complex64, device=z.device)
    u[..., :n] = z * w_plus.conj()
    spec = torch.fft.fft(u)
    del u
    spec.mul_(k_plus)
    c1 = torch.fft.ifft(spec)
    del spec
    c1[..., n:] = 0.0
    c1[..., :n].mul_(gain).conj_physical_()
    spec = torch.fft.fft(c1)
    del c1
    spec.mul_(k_plus)
    c2 = torch.fft.ifft(spec)[..., :n]
    del spec
    return c2.conj_physical_().mul_(w_plus).div_(n0)
