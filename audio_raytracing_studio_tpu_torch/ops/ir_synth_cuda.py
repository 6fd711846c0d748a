"""Fused RIR-bank synthesis — port of ``audio_raytracing_studio_tpu/ops/ir_synth_pallas.py``.

The bank builds B final (early, late) IR pairs in one call, from one of two
sources of randomness:

- **hash draws** (``fused_rir_bank`` → ``_hash_bank`` → ``_rir_block_kernel``
  in JAX): per-entry seeds through the counter-based stream of ``ops.rng`` —
  the same values ``ir_synth.hash_draws`` draws, so the bank and the plain
  ``synthesize`` path agree to float round-off;
- **injected draws** (``fused_rir_bank(..., injected_draws=...)`` →
  ``_injected_bank`` → ``_rir_bank_kernel`` in JAX): explicit delays,
  strengths and noise (``pack_draws``), the oracle-parity path, with
  ``synthesize``'s raw-noise fallback for degenerate smoothing.

Each source has two producers of the final IRs:

- the hand-written CUDA kernels of ``csrc/rir_bank.cu`` (route: nvcc →
  ctypes), ``_rir_block_cuda`` and ``_rir_bank_cuda``, launched for CUDA
  tensors: a stats pass and a write pass that applies the normalizations
  itself, two launches per call and no host sync;
- their plain PyTorch versions ``_rir_block_plain`` and ``_rir_bank_plain``,
  used for CPU tensors and as the kernels' reference: the raw IRs and
  per-tile stats over (B, n_tiles, TILE), then ``_entry_scales`` (the
  Chan-combined variance restore and the 0.9 / 0.7 peaks, one scale per
  entry), the epilogue the JAX package runs after its kernel.

A CUDA tensor never takes a plain path: the kernels launch or the call
raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from . import rng
from .ir_synth import MAX_REFLECTIONS, IRScalars, IRShape, early_tap_amps, to_device

TILE = 4096  # samples per tile; csrc/rir_bank.cu kTile must match
N_STATS = 8  # per-(entry, tile) partials — see csrc/rir_bank.cu
MAX_SMOOTH_WIDTH = config.NOISE_SMOOTH_CLIP[1]  # csrc/rir_bank.cu kMaxWidth

# Bank calls that launched the CUDA kernels in this process (one per call,
# both passes together); the plain paths never count.  Render threads (the
# serving worker among them) launch concurrently, so ``_count`` adds under a
# lock; reading a count or setting it to 0 is a plain attribute access.
launch_count = 0  # hash draws
injected_launch_count = 0  # injected draws
_count_lock = threading.Lock()


def _count(name: str) -> None:
    """Add one launch to the module counter ``name``."""
    with _count_lock:
        globals()[name] += 1


def n_tiles(shape: IRShape) -> int:
    return max(1, -(-shape.length // TILE))


def _bank_plain(scal, shape: IRShape, batch: int, taps, noise_at, with_raw_tail=False):
    """Plain PyTorch body shared by both sources, vectorised over
    (B, n_tiles, TILE) → raw early, late (B, length), stats (B, n_tiles, 8)
    and, with ``with_raw_tail``, the unsmoothed tail (B, length).

    taps: ``(delays, strengths)`` (B, MAX_REFLECTIONS) or None;
    noise_at(idx): noise at tail indices idx (1, P) int64 → (B or 1, P),
    zero outside [0, late_length).  Stats slots, as the kernels' stats pass
    writes them: noise sum, noise centered M2, smoothed sum, smoothed
    centered M2, max|early|, max|late|, valid count, max|raw tail| (0
    without ``with_raw_tail``).
    """
    device = scal.device
    nblk = n_tiles(shape)
    one_minus_absorption, directionality, log_decay, initial_amp = (
        scal[:, i, None] for i in range(4)
    )
    pos = torch.arange(nblk * TILE, dtype=torch.int64, device=device)[None, :]

    # --- early taps (ref :258-268) ---
    early = torch.zeros((batch, nblk * TILE), dtype=torch.float32, device=device)
    if shape.early_taps_active:
        delays, strengths = taps
        k = torch.arange(MAX_REFLECTIONS, dtype=torch.int64, device=device)[None, :]
        amps = early_tap_amps(
            delays, strengths, shape.actual_max_early_delay,
            one_minus_absorption, directionality,
        )
        valid = (
            (k < min(MAX_REFLECTIONS, shape.reflection_count))
            & (delays > 0)
            & (delays < shape.split_point)
        )
        early.scatter_add_(
            1, torch.where(valid, delays, 0), torch.where(valid, amps, 0.0)
        )

    # --- late tail (ref :270-296) ---
    late = torch.zeros_like(early)
    raw_tail = None
    noise = smoothed = valid_tail = None
    if shape.late_length > 0:
        t = pos - shape.split_point  # tail index
        noise = noise_at(t).expand(batch, -1)
        w = shape.noise_smooth_width
        if w > 1 and shape.late_length >= w:
            lead = w // 2
            acc = torch.zeros_like(noise)
            for k in range(w):  # 'same' smoothing: tap k reads noise[t + k − lead]
                acc = acc + (noise if k == lead else noise_at(t + (k - lead)))
            smoothed = acc / float(w)
        else:
            smoothed = noise
        valid_tail = (t >= 0) & (t < shape.late_length)
        envelope = torch.exp(t.clamp(min=0).to(torch.float32) * log_decay)
        late = torch.where(valid_tail, smoothed * initial_amp * envelope, 0.0)
        if with_raw_tail:
            raw_tail = torch.where(valid_tail, noise * initial_amp * envelope, 0.0)

    # --- per-tile stats, same meaning as the kernels' ---
    stats = torch.zeros((batch, nblk, N_STATS), dtype=torch.float32, device=device)
    tiles = (batch, nblk, TILE)
    if noise is not None:
        valid = valid_tail.expand(batch, -1).reshape(tiles)
        noise = noise.reshape(tiles)
        smoothed = torch.where(valid, smoothed.reshape(tiles), 0.0)
        n_b = valid.to(torch.float32).sum(-1)
        denom = n_b.clamp(min=1.0)[..., None]
        for slot, x in ((0, noise), (2, smoothed)):
            total = x.sum(-1)
            dev = torch.where(valid, x - total[..., None] / denom, 0.0)
            stats[..., slot] = total
            stats[..., slot + 1] = (dev * dev).sum(-1)  # centered M2
        stats[..., 5] = late.reshape(tiles).abs().amax(-1)
        stats[..., 6] = n_b
        if raw_tail is not None:
            stats[..., 7] = raw_tail.reshape(tiles).abs().amax(-1)
    stats[..., 4] = early.reshape(tiles).abs().amax(-1)
    length = shape.length
    raw_tail = None if raw_tail is None else raw_tail[:, :length]
    return early[:, :length], late[:, :length], stats, raw_tail


def _hash_bank_raw(
    seeds: torch.Tensor, scal: torch.Tensor, shape: IRShape
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw early, late (B, length) and stats (B, n_tiles, 8) of the hash
    source, before any scale (what the kernels' stats pass summarizes)."""
    seed64 = seeds.to(torch.int64)[:, None]
    taps = None
    if shape.early_taps_active:
        k = torch.arange(MAX_REFLECTIONS, dtype=torch.int64, device=seeds.device)[None, :]
        hi = max(2, shape.actual_max_early_delay)
        d_bits = rng.counter_bits(rng.stream_mix(seed64, rng.DELAY_STREAM), k)
        strengths = rng.uniform_from_bits(
            rng.counter_bits(rng.stream_mix(seed64, rng.STRENGTH_STREAM), k),
            *config.EARLY_STRENGTH_RANGE,
        )
        taps = (1 + d_bits % max(1, hi - 1), strengths)
    noise_mix = rng.stream_mix(seed64, rng.NOISE_STREAM)

    def noise_at(idx):  # re-hashed at any index: counter-based draws
        u = rng.uniform_from_bits(rng.counter_bits(noise_mix, idx), -1.0, 1.0)
        return torch.where((idx >= 0) & (idx < shape.late_length), u, 0.0)

    early, late, stats, _ = _bank_plain(scal, shape, seeds.shape[0], taps, noise_at)
    return early, late, stats


def _injected_bank_raw(delays, strengths, noise, scal, shape: IRShape):
    """Raw early, late (B, length), stats (B, n_tiles, 8) and the raw-noise
    tail (B, length) of the injected source (``pack_draws`` layout)."""
    batch = delays.shape[0]
    padded = torch.nn.functional.pad(noise, (0, 1))  # column late_length.. reads 0
    last = padded.shape[1] - 1

    def noise_at(idx):
        inside = (idx >= 0) & (idx < shape.late_length)
        col = torch.where(inside, idx, last).expand(batch, -1)
        return torch.gather(padded, 1, col)

    taps = (delays.to(torch.int64), strengths) if shape.early_taps_active else None
    return _bank_plain(scal, shape, batch, taps, noise_at, with_raw_tail=True)


def _smoothing_active(shape: IRShape) -> bool:
    w = shape.noise_smooth_width
    return shape.late_length > 0 and w > 1 and shape.late_length >= w


def _tail_stds(stats: torch.Tensor, shape: IRShape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(std of the raw noise, std of the smoothed noise) over the tail, per
    entry, Chan-combining the per-tile centered moments:
    var = (Σ M2_b + Σ n_b·(mean_b − mean)²)/n."""
    n = float(shape.late_length)
    n_b = stats[:, :, 6]  # valid tail samples per tile (Σ = late_length)

    def _std(sums, m2s):
        mean = sums.sum(dim=1) / n
        mean_b = sums / n_b.clamp(min=1.0)
        between = (n_b * (mean_b - mean[:, None]).square()).sum(dim=1)
        return ((m2s.sum(dim=1) + between) / n).clamp(min=0.0).sqrt()

    return _std(stats[:, :, 0], stats[:, :, 1]), _std(stats[:, :, 2], stats[:, :, 3])


def _entry_scales(stats: torch.Tensor, shape: IRShape, fallback: bool):
    """Global normalizations from per-tile partials (ref :289-290, :299-303)
    → (early_scale, late_scale, raw) per entry, as the kernels' write pass
    derives them.

    Scalar factors commute with |·| maxima, so the smoothing variance
    restore (std_raw/std_smooth) and the 0.9/0.7 peak normalizations fold
    into one multiplier per entry.  With ``fallback`` (injected draws) an
    entry whose smoothed tail has std ≤ 1e-6 is ``raw``: its tail is the raw
    noise, peak-normalized by slot 7, with no variance restore.
    """
    max_e = stats[:, :, 4].amax(dim=1)
    max_t = stats[:, :, 5].amax(dim=1)
    raw = torch.zeros_like(max_t, dtype=torch.bool)
    c = torch.ones_like(max_t)
    if _smoothing_active(shape):
        std_n, std_s = _tail_stds(stats, shape)
        restore = std_s > 1e-6
        c = torch.where(restore, std_n / std_s, 1.0)
        if fallback:
            raw = ~restore
            max_t = torch.where(raw, stats[:, :, 7].amax(dim=1), max_t)
    late_peak = max_t * c
    late_scale = c * torch.where(late_peak > 1e-6, config.LATE_NORM_PEAK / late_peak, 1.0)
    early_scale = torch.where(max_e > 1e-6, config.EARLY_NORM_PEAK / max_e, 1.0)
    return early_scale, late_scale, raw


def _finalize_bank(early_raw, late_raw, stats, shape: IRShape):
    """Raw IRs and stats → final early, late (no raw-noise fallback: the
    hash source's epilogue, ``_finalize_bank`` in the JAX package)."""
    early_scale, late_scale, _ = _entry_scales(stats, shape, fallback=False)
    return early_raw * early_scale[:, None], late_raw * late_scale[:, None]


def _rir_block_plain(
    seeds: torch.Tensor, scal: torch.Tensor, shape: IRShape
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the hash-draws kernels → final early, late
    (B, length)."""
    return _finalize_bank(*_hash_bank_raw(seeds, scal, shape), shape)


def _rir_bank_plain(
    delays: torch.Tensor,
    strengths: torch.Tensor,
    noise: torch.Tensor,
    scal: torch.Tensor,
    shape: IRShape,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the injected-draws kernels (``pack_draws``
    layout) → final early, late (B, length) and the (B,) bool flags of the
    entries that kept their raw noise (``synthesize``'s fallback)."""
    early, late, stats, raw_tail = _injected_bank_raw(delays, strengths, noise, scal, shape)
    early_scale, late_scale, raw = _entry_scales(stats, shape, fallback=True)
    if raw_tail is not None:
        late = torch.where(raw[:, None], raw_tail, late)
    return early * early_scale[:, None], late * late_scale[:, None], raw


@functools.lru_cache(maxsize=None)
def _launcher():
    """Build (at first use) and bind ``rir_bank_launch`` from csrc/rir_bank.cu."""
    from ..utils import kernels

    fn = kernels.load("rir_bank").rir_bank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5  # seeds, scal, early, late, stats
        + [ctypes.c_int] * 10  # batch, tile, the seven IRShape ints, unit_scales
        + [ctypes.c_float] * 3  # strength lo, strength span, delay decay exp
        + [ctypes.c_void_p]  # cudaStream_t
    )
    return fn


def _outputs(batch: int, shape: IRShape, device):
    """early, late (B, length) and the stats scratch (B, n_tiles, 8): views
    of one allocation, each starting on a 16-byte boundary."""
    span = -(-batch * shape.length // 4) * 4
    n_stats = batch * n_tiles(shape) * N_STATS
    buf = torch.empty(2 * span + n_stats, dtype=torch.float32, device=device)
    early = buf[: batch * shape.length].view(batch, shape.length)
    late = buf[span: span + batch * shape.length].view(batch, shape.length)
    stats = buf[2 * span:].view(batch, n_tiles(shape), N_STATS)
    return early, late, stats


def _check_width(shape: IRShape) -> None:
    if shape.noise_smooth_width > MAX_SMOOTH_WIDTH:
        raise ValueError(
            f"the CUDA bank smooths at most {MAX_SMOOTH_WIDTH} taps "
            f"(config.NOISE_SMOOTH_CLIP), got {shape.noise_smooth_width}"
        )


def _rir_block_cuda(
    seeds: torch.Tensor, scal: torch.Tensor, shape: IRShape, unit_scales: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the hash-draws bank of csrc/rir_bank.cu (stats pass, then write
    pass) → final early, late (B, length).  ``unit_scales`` (checks only)
    writes the samples before the per-entry scales."""
    if seeds.device.type != "cuda" or scal.device != seeds.device:
        raise ValueError(
            f"rir_bank needs seeds and scalars on one CUDA device, got "
            f"{seeds.device} and {scal.device}"
        )
    batch = seeds.shape[0]
    if seeds.dtype != torch.int32 or seeds.shape != (batch,):
        raise ValueError(f"seeds must be (B,) int32, got {tuple(seeds.shape)} {seeds.dtype}")
    if scal.dtype != torch.float32 or scal.shape != (batch, 4):
        raise ValueError(f"scalars must be (B, 4) float32, got {tuple(scal.shape)} {scal.dtype}")
    if not (seeds.is_contiguous() and scal.is_contiguous()):
        raise ValueError("seeds and scalars must be contiguous")
    _check_width(shape)
    launch = _launcher()
    device = seeds.device
    early, late, stats = _outputs(batch, shape, device)
    lo, hi = config.EARLY_STRENGTH_RANGE
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            seeds.data_ptr(), scal.data_ptr(), early.data_ptr(), late.data_ptr(),
            stats.data_ptr(), batch, TILE, shape.length, shape.split_point,
            shape.actual_max_early_delay, shape.reflection_count,
            shape.late_length, shape.noise_smooth_width,
            int(shape.early_taps_active), int(unit_scales), lo, float(np.float32(hi - lo)),
            config.EARLY_DELAY_DECAY_EXP, stream,
        )
    if err != 0:
        raise RuntimeError(f"rir_bank launch failed with CUDA error {err}")
    _count("launch_count")
    return early, late


@functools.lru_cache(maxsize=None)
def _injected_launcher():
    """Bind ``rir_bank_injected_launch`` from csrc/rir_bank.cu (same library)."""
    from ..utils import kernels

    fn = kernels.load("rir_bank").rir_bank_injected_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3  # delays, strengths, noise
        + [ctypes.c_int]  # noise row stride
        + [ctypes.c_void_p] * 5  # scal, early, late, stats, raw flags
        + [ctypes.c_int] * 10  # batch, tile, the seven IRShape ints, unit_scales
        + [ctypes.c_float]  # delay decay exp
        + [ctypes.c_void_p]  # cudaStream_t
    )
    return fn


def _rir_bank_cuda(
    delays: torch.Tensor,
    strengths: torch.Tensor,
    noise: torch.Tensor,
    scal: torch.Tensor,
    shape: IRShape,
    unit_scales: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the injected-draws bank (stats pass, then write pass) → final
    early, late (B, length) and, for checks, the (B,) bool flags of the
    entries that kept their raw noise.  ``unit_scales`` (checks only)
    writes the samples before the per-entry scales."""
    device = delays.device
    batch = delays.shape[0]
    if device.type != "cuda" or any(x.device != device for x in (strengths, noise, scal)):
        raise ValueError(
            "rir_bank_injected needs delays, strengths, noise and scalars on one CUDA "
            f"device, got {[str(x.device) for x in (delays, strengths, noise, scal)]}"
        )
    expect = {
        "delays": (delays, torch.int32, (batch, MAX_REFLECTIONS)),
        "strengths": (strengths, torch.float32, (batch, MAX_REFLECTIONS)),
        "scalars": (scal, torch.float32, (batch, 4)),
    }
    for name, (x, dtype, dims) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != dims:
            raise ValueError(f"{name} must be {dims} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if (noise.dtype != torch.float32 or noise.dim() != 2 or noise.shape[0] != batch
            or noise.shape[1] < max(1, shape.late_length)):
        raise ValueError(
            f"noise must be (B, >= {max(1, shape.late_length)}) float32, "
            f"got {tuple(noise.shape)} {noise.dtype}"
        )
    if not all(x.is_contiguous() for x in (delays, strengths, noise, scal)):
        raise ValueError("delays, strengths, noise and scalars must be contiguous")
    _check_width(shape)
    launch = _injected_launcher()
    early, late, stats = _outputs(batch, shape, device)
    raw = torch.empty((batch,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            delays.data_ptr(), strengths.data_ptr(), noise.data_ptr(), noise.shape[1],
            scal.data_ptr(), early.data_ptr(), late.data_ptr(), stats.data_ptr(),
            raw.data_ptr(), batch, TILE, shape.length, shape.split_point,
            shape.actual_max_early_delay, shape.reflection_count, shape.late_length,
            shape.noise_smooth_width, int(shape.early_taps_active), int(unit_scales),
            config.EARLY_DELAY_DECAY_EXP, stream,
        )
    if err != 0:
        raise RuntimeError(f"rir_bank_injected launch failed with CUDA error {err}")
    _count("injected_launch_count")
    return early, late, raw.bool()


def pack_draws(
    shape: IRShape, delays: Sequence, strengths: Sequence, noise: Sequence
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-entry explicit draws → the injected bank's flat inputs.

    Each argument holds B rows (a 2-D array, or a list of rows of differing
    lengths).  delays/strengths: rows of ≤ MAX_REFLECTIONS taps → (B,
    MAX_REFLECTIONS) int32 / float32, zero-padded; noise → (B, max(1,
    late_length)) float32 (extra samples dropped, missing ones zero).
    """
    batch = len(delays)
    cols = max(1, shape.late_length)
    d = np.zeros((batch, MAX_REFLECTIONS), dtype=np.int32)
    s = np.zeros((batch, MAX_REFLECTIONS), dtype=np.float32)
    n = np.zeros((batch, cols), dtype=np.float32)
    for i, (di, si, ni) in enumerate(zip(delays, strengths, noise)):
        r = len(di)
        if r > MAX_REFLECTIONS:
            raise ValueError(
                f"injected draws carry {r} early taps; the static budget is "
                f"MAX_REFLECTIONS={MAX_REFLECTIONS}"
            )
        d[i, :r] = di
        s[i, :r] = si
        ni = np.asarray(ni, dtype=np.float32)[:cols]
        n[i, : ni.shape[0]] = ni
    return d, s, n


def fused_rir_bank(
    seeds: torch.Tensor,
    shape: IRShape,
    scalars: IRScalars,
    injected_draws: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesize a bank of (early, late) IRs → two (B, length) float32 tensors.

    seeds: (B,) int32 tensor — one counter-based stream per entry (use
    ``ir_synth.seeds_to_int32`` for seeds ≥ 2^31; ignored with
    ``injected_draws``); its device picks the producer: the CUDA kernels for
    a CUDA tensor, whose output is returned as it is, the plain version for
    a CPU tensor.  scalars: IRScalars of scalars or (B,) arrays (broadcast).
    injected_draws: the ``pack_draws`` triple (arrays or tensors) — explicit
    randomness, any IR length.  Host arrays reach the card through pinned
    buffers, without a synchronous copy.
    """
    batch = seeds.shape[0]
    device = seeds.device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_rir_bank runs on cuda or cpu tensors, not {device}")
    scal = scalars.table(batch, device)
    if injected_draws is not None:
        d, s, n = (to_device(x, device).contiguous() for x in injected_draws)
        producer = _rir_bank_cuda if device.type == "cuda" else _rir_bank_plain
        early, late, _ = producer(d.to(torch.int32), s.to(torch.float32),
                                  n.to(torch.float32), scal, shape)
        return early, late
    if device.type == "cuda":
        return _rir_block_cuda(seeds.contiguous(), scal, shape)
    return _rir_block_plain(seeds, scal, shape)
