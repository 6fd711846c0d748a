"""Sequence-parallel rendering of one long clip — port of
``audio_raytracing_studio_tpu/parallel/long_render.py``.

The clip's sample axis is sharded over the mesh's "block" axis, and every
stage of the render is blockwise-local (the convolution by overlap-add with
a ring ``ppermute`` halo, ``partitioned_conv``), elementwise (mix, pan), a
cheap collective (the global max of the conditional normalizations:
``pmax``), or a small neighbour halo (the 12 / 18 ms layout delays: one
``ppermute``).  Per-shard FFT size and memory stay flat as the clip grows
with the mesh.

Long mode puts the air-absorption gain on the block convolution spectra
(``StaticSpec.fast_air``; the same ≤ 1e-3 envelope).  The shelf EQ, a
whole-signal circular filter at the exact output length in the reference,
runs as the distributed exact-length Bluestein transform over the block
axis (``distributed_fft``).  The meter runs sharded: the K-weighting FIR on
the same wrap-free ring, the gating-block energies as per-shard float64
prefix differences summed by one ``psum``.

On one card standing in for D shards (``make_mesh(devices=["cuda:0"] * D)``)
every shard's buffers live on that card: its peak memory is the sum over
the shards, not one shard's share as on a mesh of D cards.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .. import config
from ..metering import kweighting as kw
from ..metering.loudness import _block_bounds, _db, gated_loudness_from_blocks, k_weighting_fir
from ..models import pipeline
from ..ops import convolution, filters, ir_synth, spatial
from ..params import RenderParams
from . import distributed_fft
from . import mesh as meshlib
from .partitioned_conv import _ring_overlap_add


def _normalize_sharded(axis: meshlib.Axis, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Conditional peak normalization with a cross-block max (ref :402-404),
    as ``filters.conditional_peak_normalize`` does over a whole clip."""
    maxes = meshlib.pmax(axis, axis.map(lambda x: x.abs().amax(), xs))

    def scale(x, max_val):
        factor = torch.where(max_val > 1.0, 1.0 / max_val, 1.0)
        return torch.where(max_val < 1e-9, 0.0, x * factor)

    return axis.map(scale, xs, maxes)


def _delay_sharded(axis: meshlib.Axis, xs: List[torch.Tensor], delay: int) -> List[torch.Tensor]:
    """Delay (..., n_block) shards by ``delay`` samples across block boundaries.

    The first ``delay`` samples of each block come from the previous block's
    tail (one ppermute hop; needs delay ≤ block length, true for the
    12 / 18 ms layout delays at any practical block size).
    """
    if delay <= 0:
        return xs
    n = xs[0].shape[-1]
    if delay > n:
        # the tail slice would silently come out shorter and the channels
        # time-mangled with no shape error: refuse instead
        raise ValueError(
            f"layout delay ({delay} samples) exceeds the per-device block "
            f"length ({n}); use fewer blocks or a longer clip"
        )
    prev = meshlib.ppermute(axis, [x[..., n - delay:] for x in xs], meshlib.ring(axis))
    # block 0 has no predecessor: its head is zeros (the reference zero-pads, :513)
    with axis.on(0):
        prev[0] = torch.zeros_like(prev[0])
    return axis.map(lambda p, x: torch.cat([p, x[..., : n - delay]], dim=-1), prev, xs)


def _map_layout_sharded(axis: meshlib.Axis, sixes: List[torch.Tensor], layout: str,
                        rate: int, z_pos: List[torch.Tensor]) -> List[torch.Tensor]:
    """Blockwise ``spatial.map_layout`` of (1, 6, n_block) shards, its delays
    crossing block boundaries."""
    if layout not in config.CHANNEL_LAYOUTS:
        layout = config.DEFAULT_CHANNEL_LAYOUT
    if layout in ("Stereo", "5.1 (Standard)"):
        return axis.map(lambda six, z: spatial.map_layout(six, layout, rate, z), sixes, z_pos)
    if layout == "7.1 (Surround)":
        delay = int(rate * config.SIDE_DELAY_MS / 1000)
        sides = _delay_sharded(axis, [six[:, 4:6] for six in sixes], delay)
        return axis.map(lambda six, s: torch.cat([six, s * config.SIDE_GAIN], dim=-2),
                        sixes, sides)
    # 5.1.2 (Atmos Light)
    delay = int(rate * config.HEIGHT_DELAY_MS / 1000)
    heights = _delay_sharded(axis, [six[:, 4:6] for six in sixes], delay)

    def add_heights(six, h, z):
        gain = z.clamp(0.0, 1.0) * config.HEIGHT_Z_GAIN
        return torch.cat([six, h * gain[:, None, None]], dim=-2)

    return axis.map(add_heights, sixes, heights, z_pos)


def _sharded_metrics(axis: meshlib.Axis, outs: List[torch.Tensor], rate: int, len_out: int,
                     block_len: int) -> dict:
    """LUFS / sample peak / RMS of a block-sharded (1, C, n_block) render,
    equal to ``metering.loudness.audio_metrics`` of the whole output.

    The K-weighting FIR rides the wrap-free ring overlap-add; each shard
    sums its own overlap with every gating block from a float64 energy
    prefix, and one ``psum`` of the (J,) contributions gives the block
    energies.  The JAX package keeps float32 prefixes in segments (its TPU
    has no fast float64); the port's meters sum in float64, which bounds
    the error by ~eps64 × the shard's energy with no segmentation.
    """
    channels = outs[0].shape[-2]
    shards = range(axis.size)

    def valid(c):
        pos = torch.arange(c * block_len, (c + 1) * block_len, device=axis.devices[c])
        return (pos < len_out).to(torch.float32)

    masks = axis.map(valid, shards)
    peaks = meshlib.pmax(axis, axis.map(lambda o, v: (o[0] * v).abs().amax(), outs, masks))
    sq_sums = meshlib.psum(
        axis, axis.map(lambda o, v: (o[0] * v).to(torch.float64).square().sum(), outs, masks))
    # the reference meters the mean of the first two channels (:687-688)
    monos = axis.map(lambda o, v: o[0, :2].mean(dim=0) * v, outs, masks)
    mono_peaks = meshlib.pmax(axis, axis.map(lambda m: m.abs().amax(), monos))

    fir_host = k_weighting_fir(int(rate)).astype(np.float32)
    firs = axis.map(lambda dev: ir_synth.to_device(fir_host, dev), axis.devices)
    conv = axis.map(
        lambda m, fir: convolution.convolve_pairwise(m[None, None], fir[None],
                                                     block_len + fir.shape[0] - 1)[0, 0],
        monos, firs)
    # wrap=False: the meter's signal runs to within < fir_len of the grid's
    # end, so a wrapped tail would add the clip ending's K-weighted tail into
    # block 0 — a circular convolution the single-device meter does not compute
    kw_local = _ring_overlap_add(axis, [c[:block_len] for c in conv],
                                 [c[block_len:] for c in conv], block_len, wrap=False)

    lo, hi, jblocks = _block_bounds(len_out, int(rate))
    with axis.on(0):
        peak_db = _db(peaks[0])
        rms_db = _db((sq_sums[0] / (len_out * channels)).sqrt())
    if jblocks <= 0:
        with axis.on(0):
            lufs = torch.full((), -torch.inf, device=axis.devices[0])
    else:
        def contributions(c, x):
            prefix = torch.nn.functional.pad(torch.cumsum(x.to(torch.float64).square(), 0),
                                             (1, 0))
            offset = c * block_len
            a = np.clip(lo[:jblocks] - offset, 0, block_len)
            b = np.clip(hi[:jblocks] - offset, 0, block_len)
            return prefix[ir_synth.to_device(b, x.device)] - prefix[ir_synth.to_device(a, x.device)]

        energy = meshlib.psum(axis, axis.map(contributions, shards, kw_local))
        with axis.on(0):
            z = energy[0] / (kw.BLOCK_SECONDS * rate)
            one = torch.ones(1, dtype=torch.float64, device=axis.devices[0])
            lufs = gated_loudness_from_blocks(z[None, :], one)
    with axis.on(0):
        lufs = torch.where(mono_peaks[0] < 1e-6, -torch.inf, lufs).to(torch.float32)
        return {"lufs": lufs, "true_peak_dbfs": peak_db, "rms_dbfs": rms_db}


def _wet(axis: meshlib.Axis, blocks, kers, scal, spec, kernel_is_late, pairwise: bool,
         block_len: int) -> List[torch.Tensor]:
    """The wet path: block convolution + ring overlap-add → (1, 2, n_block)
    shards; fast air as a gain on the block convolution grid."""
    l = int(kers[0].shape[-1])
    out_len = block_len + l - 1
    if pairwise:
        conv = axis.map(lambda x, k: convolution.convolve_pairwise(x, k, out_len), blocks, kers)
        return _ring_overlap_add(axis, [c[..., :block_len] for c in conv],
                                 [c[..., block_len:] for c in conv], block_len)

    def convolve(x, k, s):
        gains = None
        if spec.air_on and kernel_is_late:
            air = filters.air_absorption_gain(convolution.fast_fft_length(out_len), spec.rate,
                                              s.air_absorption)[0]
            gains = torch.stack([air if late else torch.ones_like(air)
                                 for late in kernel_is_late])[None]
        return convolution.convolve_full(x, k[None], out_len, kernel_gains=gains)[0]  # (K, 2, ·)

    conv = axis.map(convolve, blocks, kers, scal)
    conv_oa = _ring_overlap_add(axis, [c[..., :block_len] for c in conv],
                                [c[..., block_len:] for c in conv], block_len)

    def levels(c, s):
        if spec.early_on and spec.late_on:
            return c[0] * s.early_level + c[1] * s.late_level
        if spec.early_on:
            return c[0] * s.early_level
        if spec.late_on:
            return c[0] * s.late_level
        return torch.zeros_like(c[0])

    return axis.map(lambda c, s: levels(c, s)[None], conv_oa, scal)


def render_long(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    device_mesh: meshlib.Mesh,
    seed: int = 0,
    axis_name: str = meshlib.BLOCK_AXIS,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    with_metrics: bool = False,
):
    """Render one long clip with its sample axis sharded over the mesh.

    Internal-hall or external-IR path.  Non-unity shelf-EQ gains run through
    the distributed exact-length transform (needs a power-of-two block
    axis).  Returns (len_out, channels) float32, or ``(audio, metrics)``
    with ``with_metrics``.
    """
    from .streaming import _build_kernels

    axis = device_mesh.axis(axis_name)
    audio_nc = pipeline._ensure_stereo_host(audio)
    n_in = audio_nc.shape[0]

    # IRs, spec and mix scalars: ONE implementation shared with the
    # single-device streaming renderer — the two long-clip paths must not
    # drift apart here.  The bank runs once, on shard 0, and its kernels are
    # replicated.
    with axis.on(0) as dev0:
        kers0, kernel_is_late, pairwise, spec, scal0 = _build_kernels(
            p, rate, n_in, int(seed), external_ir, external_ir_rate, True, dev0
        )
    kers = [kers0] + [meshlib.transfer(axis, kers0, 0, k) for k in range(1, axis.size)]
    scal = [scal0] + [
        pipeline.MixScalars(*(meshlib.transfer(axis, v, 0, k) for v in scal0))
        for k in range(1, axis.size)
    ]

    len_out = spec.len_out
    if spec.eq_on:
        # the distributed exact-length EQ needs blocks aligned with its
        # power-of-two four-step FFT layout
        if not distributed_fft.is_power_of_two(axis.size):
            raise ValueError(
                "render_long with non-unity EQ gains requires a power-of-two "
                f"block axis (got {axis.size})"
            )
        block_len = distributed_fft.block_len_for(len_out, axis.size)
    else:
        block_len = math.ceil(len_out / axis.size)
    n_total = block_len * axis.size

    audio_cn = np.zeros((2, n_total), dtype=np.float32)
    audio_cn[:, :n_in] = audio_nc.T
    blocks = axis.map(
        lambda c, dev: ir_synth.to_device(
            np.ascontiguousarray(audio_cn[None, :, c * block_len:(c + 1) * block_len]), dev),
        range(axis.size), axis.devices)

    # --- wet path, then mix, EQ, normalize, pan, map (blockwise + collectives) ---
    wet = _wet(axis, blocks, kers, scal, spec, kernel_is_late, pairwise, block_len)
    col = pipeline._col
    mixed = axis.map(
        lambda x, w, s: col(s.dry_factor * (1.0 - s.dry_wet)) * x + col(s.dry_wet) * w,
        blocks, wet, scal)
    if spec.eq_on:
        mixed = distributed_fft.shelf_eq_sharded(
            axis, mixed, spec.rate, [s.bass_gain for s in scal],
            [s.treble_gain for s in scal], len_out,
        )
    mixed = _normalize_sharded(axis, mixed)
    six = axis.map(
        lambda m, s: spatial.apply_pan(m, spatial.pan_matrix(s.x_pos, s.y_pos, s.z_pos)),
        mixed, scal)
    six = _normalize_sharded(axis, six)
    out = _map_layout_sharded(axis, six, spec.layout, spec.rate, [s.z_pos for s in scal])
    out = _normalize_sharded(axis, out)
    metrics = _sharded_metrics(axis, out, spec.rate, len_out, block_len) if with_metrics else None

    # --- down: each shard's (n_block, C) rows into one host buffer ---
    channels = out[0].shape[-2]
    host = torch.empty((n_total, channels), dtype=torch.float32, pin_memory=device_mesh.is_cuda)
    done = []
    for c in range(axis.size):
        with axis.on(c):
            host[c * block_len:(c + 1) * block_len].copy_(out[c][0].T, non_blocking=True)
            if device_mesh.is_cuda:
                done.append(torch.cuda.Event())
                done[-1].record()
    if metrics is not None:
        with axis.on(0):
            metrics = {k: float(v) for k, v in metrics.items()}
    for event in done:
        event.synchronize()
    result = host[:len_out].numpy()
    return (result, metrics) if with_metrics else result
