"""End-to-end render graphs — port of ``audio_raytracing_studio_tpu/models/pipeline.py``.

Internal-hall render over a batch: IR synthesis, batched FFT convolution,
air absorption, dry/wet mix with dry-kill, shelf EQ, conditional
normalizations, 5.1 panning and layout mapping (raytracer_studio.py:338-571).
Tensors are channels-leading with an explicit batch dim, (B, C, N); the host
wrappers keep the reference's (N, C) convention.

All value scalars are derived on the host in float64 (``params``, shared
with the JAX package) and enter as float32; the static branch decisions
(EQ on, air on, early/late on) replicate the reference's host-visible skips
(:312, :360, :369, :389).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from audio_raytracing_studio_tpu import config
from audio_raytracing_studio_tpu.params import (
    IRDraws,
    RenderParams,
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
    dry_kill_factor,
    eq_enabled,
)

from ..ops import convolution, filters, ir_synth, spatial
from ..ops.ir_synth_cuda import fused_rir_bank


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
                torch.from_numpy(np.asarray(col, dtype=np.float32)).to(device)
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


def resolve_device(device) -> torch.device:
    """The device a render runs on; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for the plain PyTorch path"
        )
    return dev


def _col(x: torch.Tensor) -> torch.Tensor:
    """(B,) per-clip scalars → (B, 1, 1), broadcast over (C, N)."""
    return x[:, None, None]


def _mix_eq_spatial(
    dry: torch.Tensor, wet: torch.Tensor, scal: MixScalars, spec: StaticSpec
) -> torch.Tensor:
    """Shared back half: dry/wet mix → EQ → normalize → pan → map (B, C, N)."""
    dry_coef = scal.dry_factor * (1.0 - scal.dry_wet)
    mixed = _col(dry_coef) * dry + _col(scal.dry_wet) * wet
    if spec.eq_on:
        mixed = filters.apply_shelf_eq(mixed, spec.rate, scal.bass_gain, scal.treble_gain)
    mixed = filters.conditional_peak_normalize(mixed)

    six = spatial.apply_pan(mixed, spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos))
    six = filters.conditional_peak_normalize(six)

    out = spatial.map_layout(six, spec.layout, spec.rate, scal.z_pos)
    return filters.conditional_peak_normalize(out)


def internal_graph_with_irs(
    audio: torch.Tensor,
    early_ir: torch.Tensor,
    late_ir: torch.Tensor,
    scal: MixScalars,
    spec: StaticSpec,
) -> torch.Tensor:
    """Internal-hall render from prebuilt IRs (e.g. the fused RIR bank).

    audio (B, 2, n_in); early_ir, late_ir (B, L) → (B, channels, len_out).
    """
    len_out = spec.len_out
    batch = audio.shape[0]
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

    exact_air = spec.air_on and not spec.fast_air
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
        zeros = torch.zeros((batch, audio.shape[1], len_out), device=audio.device)
        early_wet = conv[:, 0] if spec.early_on else zeros
        late_wet = conv[:, -1] if spec.late_on else zeros
        late_wet = filters.apply_air_absorption(late_wet, spec.rate, scal.air_absorption)
        wet = early_wet * _col(scal.early_level) + late_wet * _col(scal.late_level)
    else:
        wet = torch.zeros((batch, audio.shape[1], len_out), device=audio.device)

    dry = torch.nn.functional.pad(audio, (0, len_out - spec.n_in))
    return _mix_eq_spatial(dry, wet, scal, spec)


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


def render(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    seed: Optional[int] = None,
    draws: Optional[IRDraws] = None,
    fast_filters: bool = False,
    device="cuda",
) -> np.ndarray:
    """Render one clip → (len_out, channels) float32 on the host.

    Randomness comes from ``seed`` (the counter-based stream; the IRs come
    from the fused RIR bank — the CUDA kernel on a GPU) or from injected
    ``draws`` (oracle parity; plain ``synthesize``, as in the JAX package).
    External-IR mode waits for the resampler port.
    """
    if p.use_external_ir:
        raise NotImplementedError(
            "external-IR mode is not ported yet (needs ops/resample.py)"
        )
    from . import convert  # imports this module

    dev = resolve_device(device)
    audio_nc = _ensure_stereo_host(audio)
    audio_t = torch.from_numpy(np.ascontiguousarray(audio_nc.T))[None].to(dev)
    setup = build_internal_setup(p, rate, audio_nc.shape[0], fast_filters=fast_filters)
    mix = MixScalars.stack([setup.mix_scalars], dev)
    if draws is not None:
        delays, strengths, noise = convert.draws_from_numpy(draws, dev)
        out = internal_graph(
            audio_t, delays, strengths, noise, setup.ir_scalars, mix,
            setup.ir_shape, setup.spec,
        )
    else:
        seeds = torch.from_numpy(ir_synth.seeds_to_int32([0 if seed is None else seed]))
        early_ir, late_ir = fused_rir_bank(seeds.to(dev), setup.ir_shape, setup.ir_scalars)
        out = internal_graph_with_irs(audio_t, early_ir, late_ir, mix, setup.spec)
    return out[0].cpu().numpy().T
