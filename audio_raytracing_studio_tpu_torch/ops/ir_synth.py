"""Impulse-response synthesis — port of ``audio_raytracing_studio_tpu/ops/ir_synth.py``.

The plain-PyTorch IR path (reference semantics: raytracer_studio.py:238-308):

- early reflections: a masked scatter-add over a static 80-tap budget,
- late tail: uniform noise → static-width moving average → exponential decay
  envelope computed as ``exp(k·log d)``,
- normalizations: data-dependent rescales via ``torch.where``.

Static shape ints live in ``IRShape``; the value scalars live in
``IRScalars`` (float32, derived on the host in float64).  Randomness is
either injected (``IRDraws`` — oracle-parity mode) or drawn from the
counter-based stream (``ops.rng``), the same values the JAX package and the
CUDA bank draw for the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from audio_raytracing_studio_tpu import config
from audio_raytracing_studio_tpu.params import IRGeometry

from . import rng

MAX_REFLECTIONS = config.REF_COUNT_CLIP[1]  # static tap budget (80)


class IRShape(NamedTuple):
    """Shape-determining (static, hashable) part of an IR synthesis."""

    length: int
    split_point: int
    actual_max_early_delay: int
    reflection_count: int
    late_length: int
    noise_smooth_width: int
    early_taps_active: bool

    @classmethod
    def from_geometry(cls, g: IRGeometry) -> "IRShape":
        return cls(
            length=g.length,
            split_point=g.split_point,
            actual_max_early_delay=g.actual_max_early_delay,
            reflection_count=g.reflection_count,
            late_length=g.late_length,
            noise_smooth_width=g.noise_smooth_width,
            early_taps_active=g.early_taps_active,
        )


class IRScalars(NamedTuple):
    """float32 value scalars (host-derived in float64); each field is a
    scalar or a per-entry (B,) array."""

    one_minus_absorption: np.ndarray
    directionality: np.ndarray
    log_decay_factor: np.ndarray
    initial_late_amp: np.ndarray

    @classmethod
    def from_geometry(cls, g: IRGeometry) -> "IRScalars":
        # the log of the decay factor MUST be taken on the host in float64:
        # the factor sits within ~2e-5 of 1.0, so a float32 log would lose
        # ~3 digits and skew the tail envelope by percents over a 10 s IR
        return cls(
            one_minus_absorption=np.float32(1.0 - g.absorption),
            directionality=np.float32(g.directionality),
            log_decay_factor=np.float32(math.log(g.decay_factor)),
            initial_late_amp=np.float32(g.initial_late_amp),
        )

    @classmethod
    def stack(cls, entries) -> "IRScalars":
        """Per-entry scalars → one IRScalars of (B,) float32 arrays."""
        return cls(*(np.asarray(col, dtype=np.float32) for col in zip(*entries)))

    def table(self, batch: int, device) -> torch.Tensor:
        """(B, 4) float32 table: 1−absorption, directionality, log_decay,
        initial_amp — the layout the RIR bank takes."""
        cols = [np.broadcast_to(np.asarray(x, np.float32), (batch,)) for x in self]
        return torch.from_numpy(np.stack(cols, axis=1)).to(device)


def seed_to_u32(seed) -> int:
    """Any Python int (e.g. os.urandom values ≥ 2^31) → its uint32 pattern."""
    return int(seed) & rng.MASK32


def seeds_to_int32(seeds) -> np.ndarray:
    """Seeds → the int32 carrier the bank kernel takes (same bit pattern)."""
    return np.asarray([seed_to_u32(s) for s in seeds], np.uint32).view(np.int32)


def hash_draws(
    seed, shape: IRShape, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw (delays, strengths, noise) from the counter-based stream (ops.rng).

    Uses the full static MAX_REFLECTIONS budget; taps beyond the shape's
    reflection_count are masked out downstream.
    """
    seed = seed_to_u32(seed)
    hi = max(2, shape.actual_max_early_delay)
    k = torch.arange(MAX_REFLECTIONS, dtype=torch.int64, device=device)
    delay_bits = rng.counter_bits(rng.stream_mix(seed, rng.DELAY_STREAM), k)
    delays = (1 + delay_bits % max(1, hi - 1)).to(torch.int32)
    strengths = rng.uniform_from_bits(
        rng.counter_bits(rng.stream_mix(seed, rng.STRENGTH_STREAM), k),
        *config.EARLY_STRENGTH_RANGE,
    )
    t = torch.arange(max(1, shape.late_length), dtype=torch.int64, device=device)
    noise = rng.uniform_from_bits(
        rng.counter_bits(rng.stream_mix(seed, rng.NOISE_STREAM), t), -1.0, 1.0
    )
    return delays, strengths, noise


def _moving_average_same(noise: torch.Tensor, width: int) -> torch.Tensor:
    """np.convolve(x, ones(w)/w, mode='same') with static width.

    'same' keeps the centre of the full convolution, leading offset w//2
    (raytracer_studio.py:288).  A direct sum of ``width`` (≤ 10) shifted
    copies: a float32 cumsum would accumulate random-walk error that the
    downstream convolution amplifies past the 1e-3 parity budget.
    """
    if width <= 1:
        return noise
    n = noise.shape[-1]
    lead = width // 2
    padded = torch.nn.functional.pad(noise, (lead, width - 1 - lead))
    acc = padded[..., 0:n]
    for k in range(1, width):
        acc = acc + padded[..., k : k + n]
    return acc / width


def early_tap_amps(
    delays: torch.Tensor,
    strengths: torch.Tensor,
    actual_max_early_delay: int,
    one_minus_absorption: torch.Tensor,
    directionality: torch.Tensor,
) -> torch.Tensor:
    """The early-tap amplitude law (ref :263-267): strength · (1−absorption)
    · clip(directionality, 0.1, 1) · distance falloff.  The CUDA bank
    (csrc/rir_bank.cu) evaluates the same expression in the same order."""
    falloff = 1.0 - (
        delays.to(torch.float32) / float(actual_max_early_delay)
    ) ** config.EARLY_DELAY_DECAY_EXP
    return (
        strengths
        * one_minus_absorption
        * torch.clamp(directionality, 0.1, 1.0)
        * falloff
    )


def synthesize(
    shape: IRShape,
    delays: torch.Tensor,
    strengths: torch.Tensor,
    noise: torch.Tensor,
    scalars: IRScalars,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (early_ir, late_ir) for one entry, both of length ``shape.length``.

    ``delays``/``strengths`` are (MAX_REFLECTIONS,), ``noise`` is
    (≥ late_length,); ``scalars`` holds float32 scalars.
    """
    s = shape
    device = noise.device
    sc = [torch.tensor(np.float32(x), device=device) for x in scalars]
    one_minus_absorption, directionality, log_decay, initial_amp = sc
    early_ir = torch.zeros(s.length, dtype=torch.float32, device=device)
    late_ir = torch.zeros(s.length, dtype=torch.float32, device=device)

    # --- Early reflections: masked scatter-add (ref :258-268) ---
    if s.early_taps_active:
        tap_index = torch.arange(MAX_REFLECTIONS, device=device)
        delays = delays.to(torch.int64)
        valid = (tap_index < s.reflection_count) & (delays > 0) & (delays < s.split_point)
        amp = early_tap_amps(
            delays, strengths, s.actual_max_early_delay,
            one_minus_absorption, directionality,
        )
        amp = torch.where(valid, amp, 0.0)
        # masked taps add 0.0 at sample 0, which is silent by construction
        early_ir = early_ir.index_add(0, torch.where(valid, delays, 0), amp)

    # --- Late tail (ref :270-296) ---
    if s.late_length > 0:
        w = s.noise_smooth_width
        if w > 1 and s.late_length >= w:
            smoothed = _moving_average_same(noise, w)
            std_raw = torch.std(noise, correction=0)  # population std, as jnp.std
            std_smooth = torch.std(smoothed, correction=0)
            smoothed = torch.where(
                std_smooth > 1e-6, smoothed / std_smooth * std_raw, noise
            )
        else:
            smoothed = noise
        k = torch.arange(s.late_length, dtype=torch.float32, device=device)
        envelope = torch.exp(k * log_decay)
        late_ir[s.split_point :] = smoothed[: s.late_length] * initial_amp * envelope

    # --- Normalization (ref :299-303) ---
    if s.length > 1:
        early_max = early_ir[1:].abs().max()
        early_ir = early_ir * torch.where(
            early_max > 1e-6, config.EARLY_NORM_PEAK / early_max, 1.0
        )
    late_max = late_ir.abs().max()
    late_ir = late_ir * torch.where(late_max > 1e-6, config.LATE_NORM_PEAK / late_max, 1.0)
    return early_ir, late_ir
