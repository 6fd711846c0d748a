"""Fused RIR-bank synthesis — port of ``audio_raytracing_studio_tpu/ops/ir_synth_pallas.py``
(the hash path: ``fused_rir_bank`` → ``_hash_bank`` → ``_rir_block_kernel``).

The bank builds B (early, late) IR pairs from per-entry seeds with the
counter-based stream of ``ops.rng`` — the same values ``ir_synth.hash_draws``
draws, so the bank and the plain ``synthesize`` path agree to float
round-off.  Two producers of the raw IRs and per-tile stats:

- ``_rir_block_cuda``: the hand-written CUDA kernel ``csrc/rir_bank.cu``
  (route: nvcc → ctypes), launched for CUDA tensors;
- ``_rir_block_plain``: the same function in plain PyTorch over
  (B, n_tiles, TILE), used for CPU tensors and as the kernel's reference.

Both feed ``_finalize_bank`` (plain torch), which Chan-combines the per-tile
moments and folds the variance restore and the 0.9/0.7 peak normalizations
into one scale per entry.  A CUDA tensor never takes the plain path: the
kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from audio_raytracing_studio_tpu import config

from . import rng
from .ir_synth import MAX_REFLECTIONS, IRScalars, IRShape, early_tap_amps

TILE = 4096  # samples per tile; csrc/rir_bank.cu kTile must match
N_STATS = 8  # per-(entry, tile) partials — see csrc/rir_bank.cu

# Launches of the CUDA kernel in this process; the plain path never counts.
launch_count = 0


def n_tiles(shape: IRShape) -> int:
    return max(1, -(-shape.length // TILE))


def _rir_block_plain(
    seeds: torch.Tensor, scal: torch.Tensor, shape: IRShape
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel → raw early, late (B, length) and
    stats (B, n_tiles, 8), vectorised over (B, n_tiles, TILE)."""
    device = seeds.device
    batch = seeds.shape[0]
    nblk = n_tiles(shape)
    seed64 = seeds.to(torch.int64)[:, None]
    one_minus_absorption, directionality, log_decay, initial_amp = (
        scal[:, i, None] for i in range(4)
    )
    pos = torch.arange(nblk * TILE, dtype=torch.int64, device=device)[None, :]

    # --- early taps (ref :258-268) ---
    early = torch.zeros((batch, nblk * TILE), dtype=torch.float32, device=device)
    if shape.early_taps_active:
        k = torch.arange(MAX_REFLECTIONS, dtype=torch.int64, device=device)[None, :]
        hi = max(2, shape.actual_max_early_delay)
        d_bits = rng.counter_bits(rng.stream_mix(seed64, rng.DELAY_STREAM), k)
        delays = 1 + d_bits % max(1, hi - 1)
        strengths = rng.uniform_from_bits(
            rng.counter_bits(rng.stream_mix(seed64, rng.STRENGTH_STREAM), k),
            *config.EARLY_STRENGTH_RANGE,
        )
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
    noise = smoothed = valid_tail = None
    if shape.late_length > 0:
        noise_mix = rng.stream_mix(seed64, rng.NOISE_STREAM)
        t = pos - shape.split_point  # tail index; noise counter

        def noise_at(idx):
            u = rng.uniform_from_bits(rng.counter_bits(noise_mix, idx), -1.0, 1.0)
            return torch.where((idx >= 0) & (idx < shape.late_length), u, 0.0)

        noise = noise_at(t)
        w = shape.noise_smooth_width
        if w > 1 and shape.late_length >= w:
            lead = w // 2
            acc = torch.zeros_like(noise)
            for k in range(w):  # 'same' smoothing, re-hashed at shifted indices
                acc = acc + (noise if k == lead else noise_at(t + (k - lead)))
            smoothed = acc / float(w)
        else:
            smoothed = noise
        valid_tail = (t >= 0) & (t < shape.late_length)
        envelope = torch.exp(t.clamp(min=0).to(torch.float32) * log_decay)
        late = torch.where(valid_tail, smoothed * initial_amp * envelope, 0.0)

    # --- per-tile stats, same meaning as the kernel's ---
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
    stats[..., 4] = early.reshape(tiles).abs().amax(-1)
    return early[:, : shape.length], late[:, : shape.length], stats


@functools.lru_cache(maxsize=None)
def _launcher():
    """Build (at first use) and bind ``rir_bank_launch`` from csrc/rir_bank.cu."""
    from ..utils import kernels

    fn = kernels.load("rir_bank").rir_bank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5  # seeds, scal, early, late, stats
        + [ctypes.c_int] * 9  # batch, tile, the seven IRShape ints
        + [ctypes.c_float] * 3  # strength lo, strength span, delay decay exp
        + [ctypes.c_void_p]  # cudaStream_t
    )
    return fn


def _rir_block_cuda(
    seeds: torch.Tensor, scal: torch.Tensor, shape: IRShape
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/rir_bank.cu → raw early, late (B, length), stats (B, n_tiles, 8)."""
    global launch_count
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
    launch = _launcher()
    device = seeds.device
    early = torch.empty((batch, shape.length), dtype=torch.float32, device=device)
    late = torch.empty_like(early)
    stats = torch.empty((batch, n_tiles(shape), N_STATS), dtype=torch.float32, device=device)
    lo, hi = config.EARLY_STRENGTH_RANGE
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            seeds.data_ptr(), scal.data_ptr(), early.data_ptr(), late.data_ptr(),
            stats.data_ptr(), batch, TILE, shape.length, shape.split_point,
            shape.actual_max_early_delay, shape.reflection_count,
            shape.late_length, shape.noise_smooth_width,
            int(shape.early_taps_active), lo, float(np.float32(hi - lo)),
            config.EARLY_DELAY_DECAY_EXP, stream,
        )
    if err != 0:
        raise RuntimeError(f"rir_bank launch failed with CUDA error {err}")
    launch_count += 1
    return early, late, stats


def _finalize_bank(early_raw, late_raw, stats, shape: IRShape):
    """Global normalizations from per-tile partials (ref :289-290, :299-303).

    Scalar factors commute with |·| maxima, so the smoothing variance
    restore (std_raw/std_smooth) and the 0.9/0.7 peak normalizations fold
    into one per-entry multiplier.
    """
    max_e = stats[:, :, 4].amax(dim=1)
    max_t = stats[:, :, 5].amax(dim=1)

    w = shape.noise_smooth_width
    if shape.late_length > 0 and w > 1 and shape.late_length >= w:
        n = float(shape.late_length)
        n_b = stats[:, :, 6]  # valid tail samples per tile (Σ = late_length)

        def _variance(sums, m2s):
            """Chan-combine per-tile centered moments:
            var = (Σ M2_b + Σ n_b·(mean_b − mean)²)/n."""
            mean = sums.sum(dim=1) / n
            mean_b = sums / n_b.clamp(min=1.0)
            between = (n_b * (mean_b - mean[:, None]).square()).sum(dim=1)
            return ((m2s.sum(dim=1) + between) / n).clamp(min=0.0)

        std_n = _variance(stats[:, :, 0], stats[:, :, 1]).sqrt()
        std_s = _variance(stats[:, :, 2], stats[:, :, 3]).sqrt()
        c = torch.where(std_s > 1e-6, std_n / std_s, 1.0)
    else:
        c = torch.ones_like(max_t)

    late_peak = max_t * c
    late_scale = c * torch.where(late_peak > 1e-6, config.LATE_NORM_PEAK / late_peak, 1.0)
    early_scale = torch.where(max_e > 1e-6, config.EARLY_NORM_PEAK / max_e, 1.0)
    return early_raw * early_scale[:, None], late_raw * late_scale[:, None]


def fused_rir_bank(
    seeds: torch.Tensor, shape: IRShape, scalars: IRScalars
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesize a bank of (early, late) IRs → two (B, length) float32 tensors.

    seeds: (B,) int32 tensor — one counter-based stream per entry (use
    ``ir_synth.seeds_to_int32`` for seeds ≥ 2^31); its device picks the
    producer: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.  scalars: IRScalars of scalars or (B,) arrays (broadcast).
    """
    batch = seeds.shape[0]
    scal = scalars.table(batch, seeds.device)
    if seeds.device.type == "cuda":
        raw = _rir_block_cuda(seeds.contiguous(), scal, shape)
    elif seeds.device.type == "cpu":
        raw = _rir_block_plain(seeds, scal, shape)
    else:
        raise ValueError(f"fused_rir_bank runs on cuda or cpu tensors, not {seeds.device}")
    return _finalize_bank(*raw, shape)
