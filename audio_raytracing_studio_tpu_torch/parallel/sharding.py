"""Batched rendering on one device or over a device mesh — port of
``render_batch`` in ``audio_raytracing_studio_tpu/parallel/sharding.py``.

One batch renders as one pass of batched tensor ops: the fused RIR bank
(the CUDA kernel on a GPU) synthesizes every clip's IRs — or one external
stereo IR serves the whole batch — then the graph convolves, mixes and maps
all clips at once, and optionally meters them (``with_metrics``) and
quantizes to PCM16 on the device.  Value-parameter sweeps (air, position,
mix, EQ, levels) share a batch; shape-determining parameters (hall type,
room size, z position, clip length, rate, layout) must match across it.

Over a mesh (``device_mesh``) the batch splits into equal row blocks along
the data axis and each shard runs that same pass over its rows, on its own
device and stream — the counterpart of the JAX package's
``_sharded_pallas_fn``, where each device runs the Pallas bank and the
render over its batch shard.

On a card nothing between the upload and the copy down makes the host wait:
the clips and every small table go up through pinned buffers with
asynchronous copies, the result comes down into pinned memory the same way,
and an event per shard marks its end — ``render_batch(async_results=True)``
returns a ``fetch()`` that waits on those events alone (``_Download``),
which is what lets the serving batcher overlap one group's copies with the
next group's render.  Without a mesh all of it is enqueued on the caller's
current stream.

Under a torch profiler (``utils.profiling``) each call records its spans:
``ars.render_batch`` around the call, and inside it ``ars.setup`` (host
work before anything is enqueued), ``ars.upload``, the graph's ``ars.conv``,
``ars.air``, ``ars.back_half`` (with ``ars.eq`` inside), ``ars.meter`` and
``ars.download``, each shard's on its own stream; and it adds the cuFFT
plans it built to the counter ``ars.fft_plans_built``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..metering import kweighting as kw
from ..metering import loudness
from ..models import pipeline
from ..ops import filters, ir_synth
from ..ops.ir_synth_cuda import fused_rir_bank
from ..params import RenderParams, eq_enabled
from ..utils import profiling
from ..utils.runtime import ensure_device, fft_plan_cache
from . import mesh as meshlib

IR_BACKENDS = ("bank", "jnp")


def bucket_length(n: int, rate: int) -> int:
    """Quantize a clip length up to a half-second grid — the batching key of
    the directory renderer (``cli.render_dir``), and the padded length of the
    binaural mix (``ops.binaural``), whose FFT size it sets."""
    step = max(1, rate // 2)
    return -(-int(n) // step) * step


def _batched_internal(
    audio: torch.Tensor,
    seeds: torch.Tensor,
    ir_scalars: ir_synth.IRScalars,
    mix_scalars: pipeline.MixScalars,
    ir_shape: ir_synth.IRShape,
    spec: pipeline.StaticSpec,
    ir_backend: str = "bank",
    eq_dyn: Optional[filters.EQDyn] = None,
) -> torch.Tensor:
    """Device-resident batched render → (B, channels, len_out) float32.

    audio (B, 2, n_in) and seeds (B,) int32 live on the render device;
    ir_scalars holds (B,) arrays, mix_scalars (B,) tensors on that device.
    ``ir_backend="bank"`` takes the IRs from ``fused_rir_bank``;
    ``"jnp"`` (named after the JAX package's backend) runs the plain
    per-clip ``synthesize`` on the same seeds, for comparison only.
    ``eq_dyn``: per-clip true output lengths and band edges for the EQ of
    padded clips (``filters.apply_shelf_eq_dynamic``).
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
    return pipeline.internal_graph_with_irs(audio, early, late, mix_scalars, spec, eq_dyn)


def _meter(out: torch.Tensor, rate: int, valid_lens: Optional[Sequence[int]]) -> dict:
    """Meter each clip (masked to its true output length when given —
    zero-padded tails stay out of the measurement)."""
    if valid_lens is None:
        return loudness.audio_metrics(out, rate)
    # block counts are float64 host math (kweighting.block_count)
    blocks = [kw.block_count(v, rate) for v in valid_lens]
    as_t = lambda xs: ir_synth.to_device(np.asarray(xs, np.int64), out.device)  # noqa: E731
    return loudness.audio_metrics_masked(out, rate, as_t(valid_lens), as_t(blocks))


def staging_clips(batch: int, n: int, channels: int, device) -> np.ndarray:
    """An uninitialised (batch, n, channels) float32 host array to stack a
    batch of clips in — page-locked when ``device`` is a card, so that
    ``render_batch`` uploads it as it lies, with no second host copy (a
    mono batch goes up at half the bytes and is duplicated on the device).

    Whoever passes such an array to ``render_batch`` must leave it alive and
    unchanged until that render's result has been fetched: the upload reads
    it asynchronously.
    """
    pinned = torch.device(device).type == "cuda"
    return torch.empty((batch, n, channels), dtype=torch.float32, pin_memory=pinned).numpy()


def _stage_clips(audio: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host clips (B, N, C) float32 → (B, 2, N) on ``dev``: mono duplicated,
    more than two channels cut to the first two
    (``pipeline._ensure_stereo_host``'s rule, raytracer_studio.py:1020-1022).
    To a card the clips go as they lie, through page-locked memory (their own,
    if ``staging_clips`` made the array, else one staging copy) and an
    asynchronous copy; the transpose and the mono duplication run on the
    device."""
    staged = torch.from_numpy(audio[:, :, :2])
    if dev.type == "cuda" and not (staged.is_contiguous() and staged.is_pinned()):
        pinned = torch.empty(staged.shape, dtype=torch.float32, pin_memory=True)
        staged = pinned.copy_(staged)
    on_dev = staged.to(dev, non_blocking=True).permute(0, 2, 1)
    return on_dev.expand(-1, 2, -1).contiguous()


class _Download:
    """Device → host completion of an enqueued batch render — port of
    ``_finalize_render`` in the JAX package's ``parallel/sharding.py``.

    Each shard's rows ``out`` (b, channels, len_out) and (b,) metric tensors
    are transposed / stacked on its device and, on a card, copied into its
    rows of one page-locked host result without waiting; an event recorded
    behind the copies on the shard's stream marks their end.  ``fetch()``
    waits on those events only, then hands out the (B, len_out, channels)
    array (a view of the page-locked buffer, which lives as long as the
    array) and one dict of floats per clip.  On the CPU there is nothing to
    wait for.
    """

    def __init__(self, batch: int):
        self.batch = batch
        self.out = self.table = self.keys = None
        self.events = []

    def put(self, row0: int, out: torch.Tensor, metrics: Optional[dict]) -> None:
        """Enqueue the copy of rows ``row0 …`` on the current stream."""
        rows = slice(row0, row0 + out.shape[0])
        out = out.permute(0, 2, 1).contiguous()
        table = None
        if metrics is not None:
            self.keys = list(metrics)
            table = torch.stack([metrics[k].reshape(out.shape[0]) for k in self.keys], dim=1)
        pinned = out.device.type == "cuda"
        if self.out is None:
            self.out = torch.empty((self.batch,) + tuple(out.shape[1:]), dtype=out.dtype,
                                   pin_memory=pinned)
            if table is not None:
                self.table = torch.empty((self.batch, table.shape[1]), dtype=table.dtype,
                                         pin_memory=pinned)
        # ``out`` and ``table`` were allocated on this stream and the copies
        # are enqueued on it, so the allocator may hand their memory on in
        # stream order as soon as these names go
        self.out[rows].copy_(out, non_blocking=True)
        if table is not None:
            self.table[rows].copy_(table, non_blocking=True)
        if pinned:
            done = torch.cuda.Event()
            done.record()
            self.events.append(done)

    def fetch(self):
        for done in self.events:
            done.synchronize()
        result = self.out.numpy()
        if self.table is None:
            return result
        cols = self.table.T.tolist()
        return result, [{k: float(col[i]) for k, col in zip(self.keys, cols)}
                        for i in range(self.batch)]


def render_batch(
    audio: np.ndarray,
    rate: int,
    params: RenderParams | Sequence[RenderParams],
    seeds: Optional[Sequence[int]] = None,
    device_mesh: Optional[meshlib.Mesh] = None,
    with_metrics: bool = False,
    ir_backend: str = "bank",
    fast_filters: bool = False,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    clip_lengths: Optional[Sequence[int]] = None,
    pcm16_output: bool = False,
    real_batch: Optional[int] = None,
    async_results: bool = False,
    device="cuda",
):
    """Render a batch of clips (B, N) or (B, N, C) on one device or over the
    data axis of ``device_mesh``.

    ``params`` is one RenderParams (shared) or one per clip — all must agree
    on shape-determining fields; value fields may sweep freely.  External
    mode (every clip ``use_external_ir``): one ``external_ir`` (samples, 2)
    at ``external_ir_rate`` (default ``rate``) serves the whole batch.

    ``device_mesh`` (``parallel.mesh.Mesh``): the batch splits into equal
    row blocks over the mesh's data axis (B must divide by it); each shard
    stages its rows, synthesizes their IRs (the bank once per shard),
    renders, meters and quantizes them on its own device and stream, and
    copies them into its rows of the host result.  The mesh's devices must
    be of ``device``'s type.

    ``clip_lengths``: per-clip TRUE input lengths of a zero-padded batch.
    Metrics then measure each clip's true output span
    ``min(len, N) + ir_len − 1``, and when a padded clip has shelf EQ on,
    every clip is EQ'd at that true length by the length-dynamic EQ
    (``filters.apply_shelf_eq_dynamic``: its cuFFT plans depend on the
    padded length, not on the true lengths).

    ``with_metrics``: the on-device meter (LUFS, sample peak, RMS) per clip.

    ``pcm16_output=True`` quantizes to the 16-bit output contract on the
    device (``pipeline.quantize_pcm16``) and returns int16.

    ``real_batch``: the first ``real_batch`` rows are real jobs; pad rows are
    dropped on the device before the copy to the host.

    ``async_results=True`` returns a zero-argument ``fetch()`` instead of the
    result: the whole render and its copy to the host are already enqueued
    (on the current stream, or on the shards' streams) and no host thread
    has waited for them; ``fetch()`` waits for the copies and returns what
    the synchronous call returns.

    Returns (B, len_out, channels) float32 (int16 with ``pcm16_output``) —
    plus a list of per-clip metric dicts with ``with_metrics``.
    """
    dev = ensure_device(device)
    with profiling.trace_span("ars.render_batch", dev):
        # the set-up enqueues nothing: its stream time is the stream waiting
        # for the host, kept out of the call's self time
        with profiling.trace_span("ars.setup", dev):
            shards, n_real, render_rows = _setup_batch(
                audio, rate, params, seeds, device_mesh, ir_backend, fast_filters,
                external_ir, external_ir_rate, clip_lengths, real_batch, dev)
        plans_before = _fft_plans(dev, device_mesh) if profiling.spans_on() else None
        download = _Download(n_real)
        for rows, on_shard in shards:
            with on_shard as here:
                out, valid_lens = render_rows(rows, here)
                keep = min(rows.stop, n_real) - rows.start
                if keep <= 0:  # pad rows only: rendered, never metered or copied
                    continue
                if keep < out.shape[0]:
                    out = out[:keep]
                    valid_lens = None if valid_lens is None else valid_lens[:keep]
                metrics = None
                if with_metrics:
                    with profiling.trace_span("ars.meter", here):
                        metrics = _meter(out, int(rate), valid_lens)
                with profiling.trace_span("ars.download", here):
                    if pcm16_output:
                        out = pipeline.quantize_pcm16(out)
                    download.put(rows.start, out, metrics)
        if plans_before is not None:
            profiling.counter_add("ars.fft_plans_built",
                                  _fft_plans(dev, device_mesh) - plans_before)
    return download.fetch if async_results else download.fetch()


def _fft_plans(dev: torch.device, device_mesh) -> Optional[int]:
    """The plans in the cuFFT caches of the cards a call renders on (each
    card once), or None off a card."""
    if dev.type != "cuda":
        return None
    devices = [dev] if device_mesh is None else [d for row in device_mesh.devices for d in row]
    caches = {c.device_index: c for c in map(fft_plan_cache, devices)}
    return sum(int(c.size) for c in caches.values())


def _setup_batch(audio, rate, params, seeds, device_mesh, ir_backend, fast_filters,
                 external_ir, external_ir_rate, clip_lengths, real_batch, dev):
    """``render_batch``'s host work before anything is enqueued: the checks,
    each clip's host-derived setup, the batch-wide spec, the seeds and the
    host side of the per-clip scalar tables → (shards, the number of real
    rows, ``render_rows(rows, device)``, which enqueues the render of
    ``rows`` → (out, their true output lengths or None))."""
    if ir_backend not in IR_BACKENDS:
        raise ValueError(f"ir_backend must be one of {IR_BACKENDS}, got {ir_backend!r}")
    if device_mesh is not None:
        axis = meshlib.check_mesh(device_mesh, dev).axis(meshlib.DATA_AXIS)

    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio[:, :, np.newaxis]
    batch = audio.shape[0]
    param_list = list(params) if isinstance(params, (list, tuple)) else [params] * batch
    if len(param_list) != batch:
        raise ValueError(f"{len(param_list)} params for batch of {batch}")
    if real_batch is not None and not 1 <= real_batch <= batch:
        raise ValueError(f"real_batch {real_batch} outside [1, {batch}]")
    if clip_lengths is not None and len(clip_lengths) != batch:
        raise ValueError(f"{len(clip_lengths)} clip_lengths for batch of {batch}")
    n_real = batch if real_batch is None else real_batch
    n_in = audio.shape[1]

    def true_lengths(ir_length: int):
        """Per-clip true output lengths, or None for an unpadded batch."""
        if clip_lengths is None:
            return None
        return [min(int(tl), n_in) + ir_length - 1 for tl in clip_lengths]

    padded_eq = clip_lengths is not None and any(
        int(tl) != n_in and eq_enabled(p.bass_gain, p.treble_gain)
        for tl, p in zip(clip_lengths, param_list)
    )
    eq_rows = {}  # ir_length → per-clip host EQDyn rows, built once per call

    def eq_host(ir_length: int) -> None:
        """Build the per-clip host EQ rows for ``ir_length`` (padded EQ-on
        batches only)."""
        if padded_eq and ir_length not in eq_rows:
            eq_rows[ir_length] = [filters.eq_dyn_host(n0, rate)
                                  for n0 in true_lengths(ir_length)]

    def eq_dyn(ir_length: int, rows: slice, here: torch.device):
        """The length-dynamic EQ's scalars for ``rows`` on ``here`` when a
        padded clip has EQ on, else None (the static EQ at the buffer
        length is then exact for every clip)."""
        if not padded_eq:
            return None
        eq_host(ir_length)
        return filters.EQDyn.stack(eq_rows[ir_length][rows], here)

    def rows_of(values, rows: slice):
        return None if values is None else values[rows]

    def mix_rows(mix_host, rows: slice, here: torch.device) -> pipeline.MixScalars:
        """``MixScalars.stack`` of ``rows``, from its host columns."""
        return pipeline.MixScalars(*(ir_synth.to_device(col[rows], here) for col in mix_host))

    if any(p.use_external_ir for p in param_list):
        if not all(p.use_external_ir for p in param_list):
            raise ValueError("mixed internal/external modes in one batch")
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir")
        if any(p.target_layout != param_list[0].target_layout for p in param_list):
            raise ValueError(
                "external-IR batch requires one target_layout for all clips "
                "(shape-determining); bucket your batch by layout"
            )
        eq_on = any(eq_enabled(p.bass_gain, p.treble_gain) for p in param_list)
        mix_host = _host_columns([pipeline._mix_scalars(p, 1.0, 1.0) for p in param_list])

        def render_rows(rows: slice, here: torch.device):
            ir = pipeline.prepare_external_ir(external_ir, external_ir_rate or rate, rate, here)
            ir_length = ir.shape[0]
            spec = pipeline.external_spec(param_list[0], rate, n_in, ir_length)._replace(
                eq_on=eq_on)
            mix = mix_rows(mix_host, rows, here)
            with profiling.trace_span("ars.upload", here):
                clips = _stage_clips(audio[rows], here)
            out = pipeline.external_graph(clips, ir.T, mix, spec, eq_dyn(ir_length, rows, here))
            return out, rows_of(true_lengths(ir_length), rows)
    else:
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
        spec = setups[0].spec._replace(**widened)
        shape0 = setups[0].ir_shape
        for s in setups[1:]:
            sw = s.spec._replace(**widened)
            if sw != spec or s.ir_shape != shape0:
                detail = (
                    f"spec {sw} vs {spec}" if sw != spec
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
        seeds32 = ir_synth.seeds_to_int32(seeds)
        ir_length = spec.ir_length
        ir_host = ir_synth.IRScalars.stack([s.ir_scalars for s in setups])
        mix_host = _host_columns([s.mix_scalars for s in setups])
        eq_host(ir_length)

        def render_rows(rows: slice, here: torch.device):
            with profiling.trace_span("ars.upload", here):
                clips = _stage_clips(audio[rows], here)
            out = _batched_internal(
                clips,
                ir_synth.to_device(seeds32[rows], here),
                ir_synth.IRScalars(*(col[rows] for col in ir_host)),
                mix_rows(mix_host, rows, here),
                shape0,
                spec,
                ir_backend=ir_backend,
                eq_dyn=eq_dyn(ir_length, rows, here),
            )
            return out, rows_of(true_lengths(ir_length), rows)

    if device_mesh is None:
        shards = [(slice(0, batch), contextlib.nullcontext(dev))]
    else:
        shards = [(rows, axis.on(k))
                  for k, rows in enumerate(meshlib.shard_rows(device_mesh, batch))]
    return shards, n_real, render_rows


def _host_columns(entries) -> list:
    """Per-clip rows of scalars → one float32 host array per field, as
    ``MixScalars.stack`` makes them before its upload."""
    return [np.asarray(col, dtype=np.float32) for col in zip(*entries)]
