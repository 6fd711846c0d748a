"""End-to-end render graphs — port of ``audio_raytracing_studio_tpu/models/pipeline.py``.

Internal-hall and external-IR renders over a batch: IR synthesis (or an
external true-stereo IR), batched FFT convolution, air absorption, dry/wet
mix with dry-kill, shelf EQ, conditional normalizations, 5.1 panning and
layout mapping (raytracer_studio.py:338-571), and optionally the meter.
Tensors are channels-leading with an explicit batch dim, (B, C, N); the host
wrappers keep the reference's (N, C) convention.

All value scalars are derived on the host in float64 (``params``, this
package's copy of the JAX package's) and enter as float32; the static
branch decisions (EQ on, air on, early/late on) replicate the reference's
host-visible skips (:312, :360, :369, :389).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops import back_half_cuda, convolution, filters, ir_synth
from ..ops.ir_synth_cuda import fused_rir_bank
from ..params import (
    IRDraws,
    RenderParams,
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
    dry_kill_factor,
    eq_enabled,
)
from ..utils import profiling
from ..utils.runtime import ensure_device


class MixScalars(NamedTuple):
    """float32 mix scalars; each field is a scalar (host) or a (B,) tensor."""

    early_level: torch.Tensor
    late_level: torch.Tensor
    dry_wet: torch.Tensor
    dry_factor: torch.Tensor
    bass_gain: torch.Tensor
    treble_gain: torch.Tensor
    air_absorption: torch.Tensor
    x_pos: torch.Tensor
    y_pos: torch.Tensor
    z_pos: torch.Tensor

    @classmethod
    def stack(cls, entries, device) -> "MixScalars":
        """Per-clip host scalars → one MixScalars of (B,) float32 tensors."""
        return cls(
            *(
                ir_synth.to_device(np.asarray(col, dtype=np.float32), device)
                for col in zip(*entries)
            )
        )


class StaticSpec(NamedTuple):
    """Static render configuration.

    ``fast_air``: apply the air-absorption gain on the convolution's FFT
    grid instead of the reference's exact-length grid — it rides the conv
    spectrum for free and deviates from the reference only in circular-wrap
    terms near the tail (≤ ~2e-4 max-abs, inside the 1e-3 contract).
    """

    n_in: int
    ir_length: int
    rate: int
    layout: str
    eq_on: bool
    air_on: bool
    early_on: bool
    late_on: bool
    fast_air: bool = False

    @property
    def len_out(self) -> int:
        return max(self.n_in, self.n_in + self.ir_length - 1)


def _col(x: torch.Tensor) -> torch.Tensor:
    """(B,) per-clip scalars → (B, 1, 1), broadcast over (C, N)."""
    return x[:, None, None]


def _mix_eq_spatial(
    audio: torch.Tensor,
    wet: torch.Tensor,
    scal: MixScalars,
    spec: StaticSpec,
    eq_dyn: Optional[filters.EQDyn] = None,
) -> torch.Tensor:
    """Shared back half: dry/wet mix → EQ → normalize → pan → map (B, C, N),
    through ``ops.back_half_cuda.back_half`` (the CUDA kernels on a card).

    audio (B, 2, n_in), the dry signal, zero past n_in; wet (B, 2, N).
    ``eq_dyn``: per-clip true output lengths and band edges of a
    zero-padded batch — the EQ then runs on each clip at its true length
    (zeros past it), overriding ``spec.eq_on``
    (``filters.apply_shelf_eq_dynamic``).
    """
    eq = None
    if eq_dyn is not None:
        def eq(mixed):
            with profiling.trace_span("ars.eq", mixed.device):
                return filters.apply_shelf_eq_dynamic(mixed, scal.bass_gain, scal.treble_gain,
                                                      eq_dyn)
    elif spec.eq_on:
        def eq(mixed):
            with profiling.trace_span("ars.eq", mixed.device):
                return filters.apply_shelf_eq(mixed, spec.rate, scal.bass_gain, scal.treble_gain)
    return back_half_cuda.back_half(audio, wet, scal, spec.layout, spec.rate, eq)


def internal_graph_with_irs(
    audio: torch.Tensor,
    early_ir: torch.Tensor,
    late_ir: torch.Tensor,
    scal: MixScalars,
    spec: StaticSpec,
    eq_dyn: Optional[filters.EQDyn] = None,
) -> torch.Tensor:
    """Internal-hall render from prebuilt IRs (e.g. the fused RIR bank).

    audio (B, 2, n_in); early_ir, late_ir (B, L) → (B, channels, len_out).
    """
    len_out = spec.len_out
    batch = audio.shape[0]
    exact_air = spec.air_on and not spec.fast_air
    with profiling.trace_span("ars.conv", audio.device):
        kernels, gains, weights = [], [], []
        fast_air = spec.air_on and spec.fast_air
        if fast_air:
            nfft = convolution.fast_fft_length(
                max(len_out, audio.shape[-1] + early_ir.shape[-1] - 1)
            )
            air_gain = filters.air_absorption_gain(nfft, spec.rate, scal.air_absorption)
        if spec.early_on:
            kernels.append(early_ir)
            weights.append(scal.early_level)
            if fast_air:
                gains.append(torch.ones_like(air_gain))
        if spec.late_on:
            kernels.append(late_ir)
            weights.append(scal.late_level)
            if fast_air:
                gains.append(air_gain)

        if kernels and not exact_air:
            # no per-kernel time-domain stage → fuse the level-weighted kernel
            # sum in the frequency domain (one inverse FFT per channel)
            wet = convolution.convolve_combined(
                audio,
                torch.stack(kernels, dim=1),
                torch.stack(weights, dim=1),
                len_out,
                kernel_gains=torch.stack(gains, dim=1) if fast_air else None,
            )
        elif kernels:
            # exact air filters the late stream at the exact output length
            # before the levels combine — keep the per-kernel streams separate
            conv = convolution.convolve_full(audio, torch.stack(kernels, dim=1), len_out)
    if kernels and exact_air:
        zeros = torch.zeros((batch, audio.shape[1], len_out), device=audio.device)
        early_wet = conv[:, 0] if spec.early_on else zeros
        late_wet = conv[:, -1] if spec.late_on else zeros
        with profiling.trace_span("ars.air", audio.device):
            late_wet = filters.apply_air_absorption(late_wet, spec.rate, scal.air_absorption)
        wet = early_wet * _col(scal.early_level) + late_wet * _col(scal.late_level)
    elif not kernels:
        wet = torch.zeros((batch, audio.shape[1], len_out), device=audio.device)

    with profiling.trace_span("ars.back_half", audio.device):
        return _mix_eq_spatial(audio, wet, scal, spec, eq_dyn)


def internal_graph(
    audio: torch.Tensor,
    delays: torch.Tensor,
    strengths: torch.Tensor,
    noise: torch.Tensor,
    ir_scalars: ir_synth.IRScalars,
    scal: MixScalars,
    ir_shape: ir_synth.IRShape,
    spec: StaticSpec,
) -> torch.Tensor:
    """Internal-hall render of one clip (B=1) from explicit draws: plain
    ``synthesize``, then ``internal_graph_with_irs``."""
    early_ir, late_ir = ir_synth.synthesize(ir_shape, delays, strengths, noise, ir_scalars)
    return internal_graph_with_irs(audio, early_ir[None], late_ir[None], scal, spec)


def external_graph(
    audio: torch.Tensor,
    ir: torch.Tensor,
    scal: MixScalars,
    spec: StaticSpec,
    eq_dyn: Optional[filters.EQDyn] = None,
) -> torch.Tensor:
    """External true-stereo IR render: L⊛IR_L, R⊛IR_R, mix, map.

    audio (B, 2, n_in); ir (2, L), shared by the batch → (B, channels, len_out).
    """
    with profiling.trace_span("ars.conv", audio.device):
        wet = convolution.convolve_pairwise(audio, ir, spec.len_out)
    with profiling.trace_span("ars.back_half", audio.device):
        return _mix_eq_spatial(audio, wet, scal, spec, eq_dyn)


def quantize_pcm16(x: torch.Tensor) -> torch.Tensor:
    """The 16-bit output contract (raytracer_studio.py:1082-1084 + libsndfile
    semantics): clip ±OUTPUT_CLIP, NaN → 0 (before the int16 cast — the
    cast of NaN is implementation-defined), ×32768 (exact in float32),
    round half to even, saturate to int16."""
    x = x.clamp(-config.OUTPUT_CLIP, config.OUTPUT_CLIP)
    x = torch.where(torch.isnan(x), 0.0, x)
    scaled = torch.round(x * 32768.0)
    return scaled.clamp(-32768.0, 32767.0).to(torch.int16)


def _ensure_stereo_host(audio: np.ndarray) -> np.ndarray:
    """Mono → duplicated stereo; >2 ch → first two (raytracer_studio.py:1020-1022)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, np.newaxis]
    if audio.shape[1] == 1:
        audio = np.repeat(audio, 2, axis=1)
    elif audio.shape[1] > 2:
        audio = audio[:, :2]
    return audio


def _mix_scalars(p: RenderParams, early_lvl: float, late_lvl: float) -> MixScalars:
    f = np.float32
    return MixScalars(
        early_level=f(early_lvl),
        late_level=f(late_lvl),
        dry_wet=f(np.clip(p.dry_wet, 0.0, 1.0)),
        dry_factor=f(dry_kill_factor(p.dry_wet, p.dry_wet_kill_start)),
        bass_gain=f(p.bass_gain),
        treble_gain=f(p.treble_gain),
        # zeroed below the reference's skip threshold (raytracer_studio.py:312)
        # so a batch whose air_on was widened batch-wide still gives
        # sub-threshold clips the reference's no-filter semantics
        air_absorption=f(
            p.air_absorption
            if p.air_absorption > config.AIR_ABSORPTION_MIN_FACTOR
            else 0.0
        ),
        x_pos=f(np.clip(p.x_pos, 0.0, 1.0)),
        y_pos=f(np.clip(p.y_pos, 0.0, 1.0)),
        z_pos=f(np.clip(p.z_pos, 0.0, 1.0)),
    )


def prepare_external_ir(ir, ir_rate: int, target_rate: int, device="cpu") -> torch.Tensor:
    """Validate and Fourier-resample an external IR to the clip's rate →
    (L, 2) float32 tensor on ``device``.

    Mirrors raytracer_studio.py:1034-1041: resample on a rate mismatch
    (``ops.resample.resample_fft``, scipy.signal.resample's semantics),
    reject non-stereo — before any resample.
    """
    ir = np.asarray(ir, dtype=np.float32)
    if ir.ndim != 2:
        raise ValueError("External IR must be a 2-D (samples, channels) array.")
    if ir.size == 0:
        raise ValueError("External IR is empty.")
    if ir.shape[1] != 2:
        raise ValueError("External IR must be stereo.")
    ir_t = ir_synth.to_device(np.ascontiguousarray(ir), device)
    if ir_rate != target_rate:
        from ..ops.resample import resample_fft

        n_resampled = int(ir.shape[0] * target_rate / ir_rate)
        if n_resampled <= 0:
            raise ValueError("Resampling would produce an empty IR.")
        if ir.shape[0] < 2:
            raise ValueError("External IR too short to resample.")
        ir_t = resample_fft(ir_t, n_resampled)
    return ir_t


def external_spec(p: RenderParams, rate: int, n_in: int, ir_length: int) -> StaticSpec:
    """Static config of an external-IR render (no air, no early/late split)."""
    return StaticSpec(
        n_in=n_in,
        ir_length=ir_length,
        rate=int(rate),
        layout=p.target_layout,
        eq_on=eq_enabled(p.bass_gain, p.treble_gain),
        air_on=False,
        early_on=False,
        late_on=False,
    )


class InternalSetup(NamedTuple):
    """Host-derived pieces of one internal-hall render."""

    ir_shape: ir_synth.IRShape
    ir_scalars: ir_synth.IRScalars
    mix_scalars: MixScalars
    spec: StaticSpec


def _internal_static(p: RenderParams, rate: int, n_in: int, fast_filters: bool):
    """Host-side static derivation (float64 param math → geometry → spec)."""
    adj_duration, adj_ref_count, adj_max_delay, adj_split = adjust_parameters_for_3d(
        p.hall_type, p.room_size, p.z_pos
    )
    directionality = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    geometry = derive_ir_geometry(
        rate,
        adj_duration,
        adj_ref_count,
        adj_max_delay,
        p.material,
        directionality,
        adj_split,
        p.diffusion,
    )
    early_lvl, late_lvl = adapt_early_late_levels(p.dry_wet, p.early_level, p.late_level)

    ir_shape = ir_synth.IRShape.from_geometry(geometry)
    spec = StaticSpec(
        n_in=n_in,
        ir_length=geometry.length,
        rate=int(rate),
        layout=p.target_layout,
        eq_on=eq_enabled(p.bass_gain, p.treble_gain),
        air_on=p.air_absorption > config.AIR_ABSORPTION_MIN_FACTOR,
        early_on=ir_shape.early_taps_active and early_lvl > 1e-6,
        late_on=ir_shape.late_length > 0 and late_lvl > 1e-6,
        fast_air=fast_filters,
    )
    return geometry, early_lvl, late_lvl, ir_shape, spec


def build_internal_spec(p: RenderParams, rate: int, n_in: int, fast_filters: bool = False):
    """Shape-only derivation → ``(spec, ir_shape)``."""
    *_, ir_shape, spec = _internal_static(p, rate, n_in, fast_filters)
    return spec, ir_shape


def build_internal_setup(
    p: RenderParams, rate: int, n_in: int, fast_filters: bool = False
) -> InternalSetup:
    """Derive all host scalars and the static config of an internal-hall
    render — shared by ``render`` and ``parallel.sharding.render_batch``."""
    geometry, early_lvl, late_lvl, ir_shape, spec = _internal_static(
        p, rate, n_in, fast_filters
    )
    return InternalSetup(
        ir_shape=ir_shape,
        ir_scalars=ir_synth.IRScalars.from_geometry(geometry),
        mix_scalars=_mix_scalars(p, early_lvl, late_lvl),
        spec=spec,
    )


def metrics_dicts(metrics: dict, batch: int) -> list:
    """(B,)-tensor metrics → one host dict of floats per clip."""
    host = {k: v.reshape(batch).cpu().tolist() for k, v in metrics.items()}
    return [{k: float(v[i]) for k, v in host.items()} for i in range(batch)]


def render(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    seed: Optional[int] = None,
    draws: Optional[IRDraws] = None,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    return_metrics: bool = False,
    fast_filters: bool = False,
    device="cuda",
):
    """Render one clip → (len_out, channels) float32 on the host, or
    ``(audio, metrics)`` with ``return_metrics`` (LUFS, sample peak and RMS
    from the on-device meter, ``metering.loudness.audio_metrics``).

    Internal hall: randomness comes from ``seed`` (the counter-based stream;
    IRs from the fused RIR bank) or from injected ``draws`` (oracle parity;
    on a GPU the injected-draws CUDA bank, on the CPU the plain
    ``synthesize``, as in the JAX package).  External mode
    (``p.use_external_ir``): pass ``external_ir`` (samples, 2) and its rate
    if it differs from ``rate``.
    """
    from . import convert  # imports this module

    dev = ensure_device(device)
    audio_nc = _ensure_stereo_host(audio)
    audio_t = torch.from_numpy(np.ascontiguousarray(audio_nc.T))[None].to(dev)
    n_in = audio_nc.shape[0]
    if p.use_external_ir:
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir data")
        ir = prepare_external_ir(external_ir, external_ir_rate or rate, rate, dev)
        spec = external_spec(p, rate, n_in, ir.shape[0])
        mix = MixScalars.stack([_mix_scalars(p, 1.0, 1.0)], dev)
        out = external_graph(audio_t, ir.T, mix, spec)
    else:
        setup = build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
        mix = MixScalars.stack([setup.mix_scalars], dev)
        if draws is not None and dev.type == "cpu":
            delays, strengths, noise = convert.draws_from_numpy(draws, dev)
            out = internal_graph(
                audio_t, delays, strengths, noise, setup.ir_scalars, mix,
                setup.ir_shape, setup.spec,
            )
        else:
            if draws is not None:
                injected = convert.bank_draws([draws], setup.ir_shape, dev)
                seeds = torch.zeros(1, dtype=torch.int32, device=dev)
            else:
                injected = None
                seeds = ir_synth.to_device(
                    ir_synth.seeds_to_int32([0 if seed is None else seed]), dev
                )
            early_ir, late_ir = fused_rir_bank(
                seeds, setup.ir_shape, setup.ir_scalars, injected_draws=injected
            )
            out = internal_graph_with_irs(audio_t, early_ir, late_ir, mix, setup.spec)
    result = out[0].cpu().numpy().T
    if return_metrics:
        from ..metering import loudness

        return result, metrics_dicts(loudness.audio_metrics(out, int(rate)), 1)[0]
    return result
