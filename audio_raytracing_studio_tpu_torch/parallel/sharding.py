"""Batched rendering on one device — port of ``render_batch`` in
``audio_raytracing_studio_tpu/parallel/sharding.py`` (no mesh yet).

One batch renders as one pass of batched tensor ops: the fused RIR bank
(the CUDA kernel on a GPU) synthesizes every clip's IRs, then the internal
graph convolves, mixes and maps all clips at once.  Value-parameter sweeps
(air, position, mix, EQ, levels) share a batch; shape-determining
parameters (hall type, room size, z position, clip length, rate, layout)
must match across it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from audio_raytracing_studio_tpu.params import RenderParams, eq_enabled

from ..models import pipeline
from ..ops import ir_synth
from ..ops.ir_synth_cuda import fused_rir_bank

IR_BACKENDS = ("bank", "jnp")


def _batched_internal(
    audio: torch.Tensor,
    seeds: torch.Tensor,
    ir_scalars: ir_synth.IRScalars,
    mix_scalars: pipeline.MixScalars,
    ir_shape: ir_synth.IRShape,
    spec: pipeline.StaticSpec,
    pcm16: bool = False,
    ir_backend: str = "bank",
) -> torch.Tensor:
    """Device-resident batched render → (B, channels, len_out).

    audio (B, 2, n_in) and seeds (B,) int32 live on the render device;
    ir_scalars holds (B,) arrays, mix_scalars (B,) tensors on that device.
    ``ir_backend="bank"`` takes the IRs from ``fused_rir_bank``;
    ``"jnp"`` (named after the JAX package's backend) runs the plain
    per-clip ``synthesize`` on the same seeds, for comparison only.
    """
    if ir_backend == "bank":
        early, late = fused_rir_bank(seeds, ir_shape, ir_scalars)
    elif ir_backend == "jnp":
        pairs = [
            ir_synth.synthesize(
                ir_shape,
                *ir_synth.hash_draws(int(s) & 0xFFFFFFFF, ir_shape, seeds.device),
                ir_synth.IRScalars(*(np.asarray(col)[i] for col in ir_scalars)),
            )
            for i, s in enumerate(seeds.tolist())
        ]
        early = torch.stack([e for e, _ in pairs])
        late = torch.stack([l for _, l in pairs])
    else:
        raise ValueError(f"ir_backend must be one of {IR_BACKENDS}, got {ir_backend!r}")
    out = pipeline.internal_graph_with_irs(audio, early, late, mix_scalars, spec)
    return pipeline.quantize_pcm16(out) if pcm16 else out


def render_batch(
    audio: np.ndarray,
    rate: int,
    params: RenderParams | Sequence[RenderParams],
    seeds: Optional[Sequence[int]] = None,
    device_mesh=None,
    with_metrics: bool = False,
    ir_backend: str = "bank",
    fast_filters: bool = False,
    clip_lengths: Optional[Sequence[int]] = None,
    pcm16_output: bool = False,
    real_batch: Optional[int] = None,
    device="cuda",
) -> np.ndarray:
    """Render a batch of clips (B, N) or (B, N, C) on one device.

    ``params`` is one RenderParams (shared) or one per clip — all must agree
    on shape-determining fields; value fields may sweep freely.

    ``clip_lengths``: per-clip true input lengths of a zero-padded batch.
    Without metering they change nothing, except that a padded clip with EQ
    on needs the length-dynamic EQ, which is not ported yet and raises.

    ``pcm16_output=True`` quantizes to the 16-bit output contract on the
    device (``pipeline.quantize_pcm16``) and returns int16.

    ``real_batch``: the first ``real_batch`` rows are real jobs; pad rows are
    dropped on the device before the copy to the host.

    Returns (B, len_out, channels) float32 (int16 with ``pcm16_output``).
    """
    if device_mesh is not None:
        raise NotImplementedError("multi-device rendering is not ported yet")
    if with_metrics:
        raise NotImplementedError("on-device metering is not ported yet")
    if ir_backend not in IR_BACKENDS:
        raise ValueError(f"ir_backend must be one of {IR_BACKENDS}, got {ir_backend!r}")
    dev = pipeline.resolve_device(device)

    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio[:, :, np.newaxis]
    batch = audio.shape[0]
    param_list = list(params) if isinstance(params, (list, tuple)) else [params] * batch
    if len(param_list) != batch:
        raise ValueError(f"{len(param_list)} params for batch of {batch}")
    if any(p.use_external_ir for p in param_list):
        raise NotImplementedError(
            "external-IR mode is not ported yet (needs ops/resample.py)"
        )
    if real_batch is not None and not 1 <= real_batch <= batch:
        raise ValueError(f"real_batch {real_batch} outside [1, {batch}]")

    clips = [pipeline._ensure_stereo_host(audio[i]) for i in range(batch)]
    n_in = clips[0].shape[0]

    if clip_lengths is not None:
        if len(clip_lengths) != batch:
            raise ValueError(f"{len(clip_lengths)} clip_lengths for batch of {batch}")
        if any(
            int(tl) != n_in and eq_enabled(p.bass_gain, p.treble_gain)
            for tl, p in zip(clip_lengths, param_list)
        ):
            raise NotImplementedError(
                "a padded clip with shelf EQ needs the length-dynamic EQ, "
                "which is not ported yet"
            )

    setups = [
        pipeline.build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
        for p in param_list
    ]
    # The on/off stage flags derive from sweepable VALUES (EQ gains, air
    # factor, early/late levels), so a sweep can flip them per clip.  Widen
    # them batch-wide: zero early/late weight is an exact no-op, unity EQ
    # gain and a zeroed air factor are identity gain curves.  Only genuinely
    # shape-determining mismatches (layout, rate, IR geometry) reject.
    widened = dict(
        eq_on=any(s.spec.eq_on for s in setups),
        air_on=any(s.spec.air_on for s in setups),
        early_on=any(s.spec.early_on for s in setups),
        late_on=any(s.spec.late_on for s in setups),
    )
    spec0 = setups[0].spec._replace(**widened)
    shape0 = setups[0].ir_shape
    for s in setups[1:]:
        sw = s.spec._replace(**widened)
        if sw != spec0 or s.ir_shape != shape0:
            detail = (
                f"spec {sw} vs {spec0}" if sw != spec0
                else f"IR geometry {s.ir_shape} vs {shape0} — z_pos, "
                     "room_size and hall_type set the IR length"
            )
            raise ValueError(
                "shape-determining parameters must match across a batch "
                f"({detail}); bucket your sweep by shape"
            )

    if seeds is None:
        seeds = range(batch)
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for batch of {batch}")
    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).to(dev)
    audio_t = torch.from_numpy(np.stack([c.T for c in clips])).to(dev)
    out = _batched_internal(
        audio_t,
        seeds_t,
        ir_synth.IRScalars.stack([s.ir_scalars for s in setups]),
        pipeline.MixScalars.stack([s.mix_scalars for s in setups], dev),
        shape0,
        spec0,
        pcm16=pcm16_output,
        ir_backend=ir_backend,
    )
    if real_batch is not None:
        out = out[:real_batch]
    return out.cpu().numpy().transpose(0, 2, 1)
