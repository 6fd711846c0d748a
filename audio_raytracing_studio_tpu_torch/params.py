"""Render parameters and the host-side (exact, float64) derived-parameter
math — copy of ``audio_raytracing_studio_tpu/params.py``.

Design: the 16 user-facing preset parameters live in a frozen ``RenderParams``.
All *scalar* derivations (hall presets, room-size scaling, directionality,
early/late level adaptation, IR geometry) run on host in float64 — exactly the
arithmetic the reference performs in Python/NumPy scalar space
(raytracer_studio.py:157-236, :168-182, :184-209) — and enter the tensor
graph as float32 scalars.  Only array math runs on the device.

Shapes (IR length, split point, smoothing width) derived here are static per
render: they size the tensors and the bank kernel's grid.  The port keeps its
own copy so that it imports nothing of the JAX package
(``tests/test_torch_config.py`` holds the two copies equal).
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np

from . import config


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """The 16 preset-visible parameters (config.PRESET_KEYS order)."""

    use_external_ir: bool = False
    hall_type: str = config.DEFAULT_HALL_TYPE
    material: str = config.DEFAULT_MATERIAL
    room_size: float = 100.0
    diffusion: float = 0.5
    air_absorption: float = 0.1
    early_level: float = 0.8
    late_level: float = 0.6
    dry_wet: float = 0.5
    dry_wet_kill_start: float = 0.5
    bass_gain: float = 1.0
    treble_gain: float = 1.0
    x_pos: float = 0.5
    y_pos: float = 0.5
    z_pos: float = 0.5
    target_layout: str = config.DEFAULT_CHANNEL_LAYOUT

    def to_preset_dict(self) -> dict:
        return {k: getattr(self, k) for k in config.PRESET_KEYS}

    @classmethod
    def from_preset_dict(cls, d: dict) -> "RenderParams":
        if not isinstance(d, dict):
            # a preset FILE may legally parse to any JSON value; .get on a
            # list/number would be an AttributeError (a 500 over HTTP, not
            # the clean 400 the error contract promises)
            raise ValueError("preset data must be a JSON object")
        kwargs = {}
        for key in config.PRESET_KEYS:
            value = d.get(key, config.PRESET_DEFAULTS[key])
            if value is None:
                value = config.PRESET_DEFAULTS[key]
            if key == "use_external_ir":
                value = bool(value)
            elif key in config.PRESET_FLOAT_KEYS:
                try:
                    value = float(value)
                except (ValueError, TypeError):
                    value = config.PRESET_DEFAULTS[key]
            elif not isinstance(value, str):
                # hall_type / material / target_layout: a non-string (e.g.
                # a JSON object in a serving-API "params" payload) would
                # TypeError later as an unhashable dict key — same
                # wrong-type-means-default policy as the float keys
                value = config.PRESET_DEFAULTS[key]
            kwargs[key] = value
        return cls(**kwargs)


def hall_base_parameters(hall_type: str) -> config.HallPreset:
    """Base hall preset; unknown types fall back to "Room".

    Mirrors raytracer_studio.py:157-166.
    """
    return config.HALL_PRESETS.get(hall_type, config.HALL_PRESETS["Room"])


def adjust_parameters_for_3d(
    hall_type: str, room_size: float, z_pos: float
) -> tuple[float, int, float, float]:
    """Scale hall base parameters by room size (m^3) and z position.

    Returns (duration_s, reflection_count, max_early_delay_s, split_time_s).
    Mirrors raytracer_studio.py:211-236 (float64 host math).
    """
    room_size = float(room_size)
    z_pos = float(z_pos)
    base = hall_base_parameters(hall_type)

    if np.isnan(room_size):
        # reference: int(nan·…) raises inside its try block and the except
        # returns adjust_reverb_parameters_by_hall(DEFAULT_HALL_TYPE) — the
        # DEFAULT hall's base parameters, NOT the requested hall's
        # (raytracer_studio.py:236).  ±inf does NOT raise there: +inf rides
        # the formula into the high clips (handled below) and −inf goes
        # complex like any negative (the ≤ 0 branch)
        fb = hall_base_parameters(config.DEFAULT_HALL_TYPE)
        return (
            float(fb.ir_duration_s),
            int(fb.reflection_count),
            float(fb.max_early_delay_s),
            float(fb.early_late_split_s),
        )
    if not np.isfinite(z_pos):
        # a NaN z would poison adj_max_delay and crash derive_ir_geometry's
        # int(); the reference degrades via its IR-generation fallback —
        # neutral z (no delay modulation) keeps a proper render instead
        z_pos = 0.5

    if room_size <= 0:
        # reference: a negative size raised to fractional powers goes
        # COMPLEX; the clipped factors resolve to the LOW bounds for all
        # practical magnitudes (verified: np.clip((-0.05)**0.33, .5, 2.5)
        # → 0.5+0j), so use the low clips directly with real math — the
        # ref-count factor below stays real either way
        size_factor_dur = config.SIZE_DUR_CLIP[0]
        size_factor_delay = config.SIZE_DELAY_CLIP[0]
    else:
        size_factor_dur = np.clip(
            (room_size / 100.0) ** config.SIZE_DUR_EXP, *config.SIZE_DUR_CLIP
        )
        size_factor_delay = np.clip(
            (room_size / 100.0) ** config.SIZE_DELAY_EXP, *config.SIZE_DELAY_CLIP
        )
    size_factor_ref = np.clip(
        1 + (room_size - 100) / config.SIZE_REF_DIVISOR, *config.SIZE_REF_CLIP
    )

    adj_duration = float(np.clip(base.ir_duration_s * size_factor_dur, *config.DURATION_CLIP))
    adj_ref_count = int(
        np.clip(int(base.reflection_count * size_factor_ref), *config.REF_COUNT_CLIP)
    )

    z_delay_factor = 1.0 + ((z_pos - 0.5) * config.Z_DELAY_SCALE)
    adj_max_delay = float(
        np.clip(
            base.max_early_delay_s * size_factor_delay * z_delay_factor,
            *config.MAX_DELAY_CLIP,
        )
    )
    adj_split_time = float(
        np.clip(base.early_late_split_s * size_factor_delay, *config.SPLIT_TIME_CLIP)
    )
    return adj_duration, adj_ref_count, adj_max_delay, adj_split_time


def compute_final_directionality_3d(
    x_pos: float,
    y_pos: float,
    z_pos: float,
    hall_type: str,
    diffusion_grade: float,
    dry_wet: float = 0.5,
) -> float:
    """Scalar reverb directionality from 3D position / hall / diffusion / mix.

    Mirrors raytracer_studio.py:184-209.
    """
    x = float(np.clip(float(x_pos), 0.0, 1.0))
    y = float(np.clip(float(y_pos), 0.0, 1.0))
    z = float(np.clip(float(z_pos), 0.0, 1.0))
    diffusion = float(np.clip(float(diffusion_grade), 0.0, 1.0))
    dw = float(np.clip(float(dry_wet), 0.0, 1.0))

    distance_from_center_xz = math.sqrt(((x - 0.5) * 2) ** 2 + ((z - 0.5) * 1.0) ** 2) / math.sqrt(
        1**2 + 0.5**2
    )
    distance_from_front_back = abs(y - 0.5) * 2
    position_factor = float(
        np.clip(
            (1.0 - distance_from_center_xz * 0.3) * (1.0 - distance_from_front_back * 0.2),
            *config.DIR_POSITION_CLIP,
        )
    )

    hall_base = config.HALL_DIRECTIONALITY_BASE.get(hall_type, config.HALL_DIRECTIONALITY_DEFAULT)
    diffusion_factor = 1.0 - (diffusion * config.DIR_DIFFUSION_SCALE)
    directionality_base = hall_base * position_factor * diffusion_factor
    boost = max(0.0, (dw - config.DIR_DW_BOOST_START) * config.DIR_DW_BOOST_SCALE)
    return float(np.clip(directionality_base + boost, *config.DIR_FINAL_CLIP))


def adapt_early_late_levels(
    dry_wet: float, base_early: float = 0.8, base_late: float = 0.6
) -> tuple[float, float]:
    """Shift early/late gains with the dry/wet knob.

    Mirrors raytracer_studio.py:168-182.
    """
    dw = float(np.clip(float(dry_wet), 0.0, 1.0))
    early_scale = 1.0 - (dw**config.EARLY_LEVEL_DW_EXP * config.EARLY_LEVEL_DW_SCALE)
    late_scale = 1.0 + (dw**config.EARLY_LEVEL_DW_EXP * config.LATE_LEVEL_DW_SCALE)
    adapted_early = float(np.clip(float(base_early) * early_scale, *config.LEVEL_CLIP))
    adapted_late = float(np.clip(float(base_late) * late_scale, *config.LEVEL_CLIP))
    return adapted_early, adapted_late


def dry_kill_factor(dry_wet: float, kill_start: float) -> float:
    """Linear dry fade-out factor over [kill_start, 1.0] of the dry/wet knob.

    Mirrors raytracer_studio.py:97-105.
    """
    dw = float(np.clip(float(dry_wet), 0.0, 1.0))
    ks = float(np.clip(float(kill_start), 0.0, 1.0))
    factor = 1.0
    if ks < 1.0 and dw >= ks:
        fade_range = 1.0 - ks
        if fade_range < 1e-6:
            factor = 0.0
        else:
            progress = (dw - ks) / fade_range
            factor = float(np.clip(1.0 - progress, 0.0, 1.0))
    return factor


def eq_enabled(bass_gain, treble_gain) -> bool:
    """The reference's host-visible shelf-EQ skip (raytracer_studio.py:389):
    EQ runs unless BOTH gains are numerically unity.

    Parity-bearing AND a static branch (StaticSpec.eq_on) — one definition
    per package, shared by models.pipeline and parallel.sharding; a
    tolerance or semantics tweak must change both packages together.
    """
    return not (np.isclose(bass_gain, 1.0) and np.isclose(treble_gain, 1.0))


@dataclasses.dataclass(frozen=True)
class IRGeometry:
    """Static (shape-determining) geometry of one internal IR synthesis.

    All fields are plain Python ints/floats (static per render).
    Mirrors the integer derivations in raytracer_studio.py:242-259, :284.
    """

    rate: int
    length: int  # total IR length in samples
    split_point: int  # early/late boundary sample
    max_delay_samples: int
    actual_max_early_delay: int  # upper bound (exclusive domain) for early delays
    reflection_count: int
    late_length: int  # length - split_point
    noise_smooth_width: int  # moving-average kernel width, 1..10
    # float64 scalar inputs to the on-device math
    ir_duration: float
    absorption: float
    directionality: float
    diffusion: float
    decay_factor: float
    initial_late_amp: float

    @property
    def early_taps_active(self) -> bool:
        """Whether the reference would generate any early taps (:258-260)."""
        return (
            self.reflection_count > 0
            and self.split_point > 1
            and self.actual_max_early_delay > 1
        )


def derive_ir_geometry(
    rate: int,
    ir_duration: float,
    reflection_count: int,
    max_delay: float,
    material: str,
    directionality: float,
    early_late_split: float,
    diffusion_grade: float,
) -> IRGeometry:
    """Host-side derivation of all IR-synthesis scalars and shapes.

    Mirrors the scalar prologue of generate_impulse_response_split_3d
    (raytracer_studio.py:242-296), keeping float64 precision so the decay
    factor and amplitudes match the reference bit-for-bit.
    """
    rate = int(rate)
    ir_duration = float(ir_duration)
    reflection_count = int(reflection_count)
    max_delay = float(max_delay)
    directionality = float(directionality)
    split_time = float(early_late_split)
    diffusion = float(diffusion_grade)

    length = max(1, int(ir_duration * rate))
    absorption = config.MATERIAL_ABSORPTION.get(
        material, config.MATERIAL_ABSORPTION[config.DEFAULT_MATERIAL]
    )
    split_point = max(1, min(int(split_time * rate), length - 1))
    max_delay_samples = max(2, int(max_delay * rate))
    actual_max_early_delay = min(max_delay_samples, split_point)

    late_length = length - split_point
    if late_length > 1:
        target_ratio = 10 ** (config.LATE_TAIL_TARGET_DB / 20.0)
        decay_factor = float(np.power(target_ratio, 1.0 / late_length))
    else:
        decay_factor = 0.1
    decay_factor = float(
        np.clip(
            decay_factor * (1.0 - absorption * config.DECAY_ABSORPTION_SCALE),
            *config.DECAY_FACTOR_CLIP,
        )
    )

    initial_late_amp = config.LATE_INITIAL_AMP * (
        1.0 - float(np.clip(directionality, *config.LATE_DIR_CLIP))
    )
    initial_late_amp *= float(
        np.clip(1.0 / (1 + ir_duration * 0.5), *config.LATE_DURATION_AMP_CLIP)
    )
    initial_late_amp *= 1.0 - absorption**0.5
    # The diffusion boost is applied after noise smoothing in the reference
    # (:294) but is a pure scalar product, so we fold it in here.
    initial_late_amp *= 1.0 + diffusion * config.LATE_DIFFUSION_AMP_BOOST

    noise_smooth_width = int(
        np.clip(
            rate * config.NOISE_SMOOTH_MS_BASE * (1.0 + diffusion * 2.0),
            *config.NOISE_SMOOTH_CLIP,
        )
    )

    return IRGeometry(
        rate=rate,
        length=length,
        split_point=split_point,
        max_delay_samples=max_delay_samples,
        actual_max_early_delay=actual_max_early_delay,
        reflection_count=reflection_count,
        late_length=late_length,
        noise_smooth_width=noise_smooth_width,
        ir_duration=ir_duration,
        absorption=float(absorption),
        directionality=directionality,
        diffusion=diffusion,
        decay_factor=decay_factor,
        initial_late_amp=float(initial_late_amp),
    )


@dataclasses.dataclass(frozen=True)
class IRDraws:
    """Explicit random draws for IR synthesis (oracle-parity injection).

    ``delays``: int array (reflection_count,), each in [1, actual_max_early_delay)
    ``strengths``: float array (reflection_count,), each in U(0.3, 0.8)
    ``noise``: float array (late_length,), each in U(-1, 1)

    When provided, the NumPy oracle, the JAX pipeline and this port consume
    these identical draws, making the ≤1e-3 parity bound a pure-math comparison
    (the reference itself is unseeded — raytracer_studio.py:262-285 — so
    run-to-run exactness is impossible even for the reference).
    """

    delays: np.ndarray
    strengths: np.ndarray
    noise: np.ndarray

    @classmethod
    def sample(cls, rng: np.random.Generator, geometry: IRGeometry) -> "IRDraws":
        hi = max(2, geometry.actual_max_early_delay)
        n = max(0, geometry.reflection_count)
        return cls(
            delays=rng.integers(1, hi, size=n),
            strengths=rng.uniform(*config.EARLY_STRENGTH_RANGE, size=n),
            noise=rng.uniform(-1.0, 1.0, size=max(0, geometry.late_length)),
        )
