"""Single-device streaming render of one long clip — port of
``audio_raytracing_studio_tpu/parallel/streaming.py``.

The clip goes through the convolution in chunks of ``chunk_seconds``: each
chunk's overlap-add convolution carries its tail into the next, so the FFT
sizes stay bounded by the chunk whatever the clip's length, and the result
does not depend on the chunk size.  Stages, as in the single-shot graph
(``models.pipeline._mix_eq_spatial``):

1. pass 1, per chunk: upload (page-locked ring, asynchronous copies; a mono
   clip goes up as one channel and is duplicated on the device) →
   convolution → dry/wet mix, written into one (2, n_total) device buffer,
   with the carried (2, l−1) tail and a running |max|.  Fast filters put the
   air gain on the chunk's convolution grid; exact filters keep the late
   stream apart, unweighted, and run the exact-length air filter over the
   whole late buffer before the levels combine;
2. the exact-length shelf EQ over the whole buffer when the gains are not
   unity (``parallel.streaming_eq``), the normalization then keying on the
   post-EQ peak;
3. pass 2 over the whole buffer: normalize → pan 2→6 → normalize → layout
   map → zero past ``len_out`` → normalize;
4. with metrics, the chunked BS.1770 meter: the K-weighting FIR per chunk
   with a carried tail, gating-block energies from per-chunk cumulative sums
   at block bounds fixed on the host, all sums in float64 on the device.

The result comes down in chunks through page-locked memory, as float32 or,
with ``pcm16_output``, as int16 quantized on the device.  Everything runs on
the caller's current stream; the host waits only for the ring's buffers and
the final copies.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..metering import kweighting as kw
from ..metering.loudness import K_FIR_LENGTH, _block_bounds, gated_loudness_from_blocks, k_weighting_fir
from ..models import pipeline
from ..ops import convolution, filters, ir_synth, spatial
from ..ops.ir_synth_cuda import fused_rir_bank
from ..params import RenderParams
from ..utils.runtime import ensure_device
from .streaming_eq import air_absorption_streaming, shelf_eq_streaming

DEFAULT_CHUNK_SECONDS = 30.0
RING_SLOTS = 3  # page-locked chunk buffers per direction


class _Ring:
    """Page-locked host buffers used in turn for asynchronous copies.  The
    event recorded after a slot's copy is waited on before the slot is
    written again, so a buffer is never reused while its copy runs."""

    def __init__(self, shape, dtype):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(RING_SLOTS)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * RING_SLOTS
        self.turn = 0

    def take(self):
        """The next slot, once the copy that last used it has ended → (slot, buffer)."""
        slot = self.turn % RING_SLOTS
        self.turn += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()
            self.events[slot] = None
        return slot, self.bufs[slot]

    def mark(self, slot: int) -> None:
        """Record the end of the copy just enqueued on ``slot``."""
        event = torch.cuda.Event()
        event.record()
        self.events[slot] = event


class _Plan(NamedTuple):
    """What one streaming render derives before it touches the audio."""

    kers: torch.Tensor  # (K, l) internal kernels, or (2, l) external IR
    kernel_is_late: List[bool]
    pairwise: bool
    spec: pipeline.StaticSpec
    scal: pipeline.MixScalars  # (1,) tensors on the device
    exact_air: bool
    chunk: int
    n_chunks: int


def _build_kernels(p: RenderParams, rate: int, n_in: int, seed: int, external_ir,
                   external_ir_rate, fast_filters: bool, dev: torch.device):
    """IRs, spec and mix scalars, as the single-shot ``pipeline.render``
    derives them: the fused RIR bank at B=1 (the CUDA kernels on a card, the
    plain version on the CPU), or a prepared external IR."""
    if p.use_external_ir:
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir")
        ir = pipeline.prepare_external_ir(
            external_ir, external_ir_rate if external_ir_rate else rate, rate, dev
        )
        spec = pipeline.external_spec(p, rate, n_in, ir.shape[0])
        scal = pipeline.MixScalars.stack([pipeline._mix_scalars(p, 1.0, 1.0)], dev)
        return ir.T.contiguous(), [], True, spec, scal

    setup = pipeline.build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
    spec = setup.spec
    seeds = ir_synth.to_device(ir_synth.seeds_to_int32([seed]), dev)
    early_ir, late_ir = fused_rir_bank(seeds, setup.ir_shape, setup.ir_scalars)
    kernels, kernel_is_late = [], []
    if spec.early_on:
        kernels.append(early_ir[0])
        kernel_is_late.append(False)
    if spec.late_on:
        kernels.append(late_ir[0])
        kernel_is_late.append(True)
    kers = (
        torch.stack(kernels) if kernels
        else torch.zeros((1, spec.ir_length), dtype=torch.float32, device=dev)
    )
    return kers, kernel_is_late, False, spec, pipeline.MixScalars.stack([setup.mix_scalars], dev)


def _plan(audio_nc: np.ndarray, rate: int, p: RenderParams, seed: int, chunk_seconds: float,
          with_metrics: bool, external_ir, external_ir_rate, fast_filters: bool,
          dev: torch.device) -> _Plan:
    n_in = audio_nc.shape[0]
    kers, kernel_is_late, pairwise, spec, scal = _build_kernels(
        p, rate, n_in, seed, external_ir, external_ir_rate, fast_filters, dev
    )
    # exact air needs the late stream apart through pass 1; with no late
    # kernel the air filter has nothing to act on either way
    exact_air = not fast_filters and not pairwise and spec.air_on and True in kernel_is_late
    l = int(kers.shape[-1])
    chunk = max(int(chunk_seconds * rate), 2 * l)
    if with_metrics:
        # the meter carries K_FIR_LENGTH − 1 samples of K-weighting tail into
        # the next chunk: a shorter chunk could not take it
        chunk = max(chunk, K_FIR_LENGTH)
    return _Plan(kers, kernel_is_late, pairwise, spec, scal, exact_air, chunk,
                 math.ceil(spec.len_out / chunk))


def _upload_chunks(audio_nc: np.ndarray, c_in: int, chunk: int, n_chunks: int, dev):
    """Yield each chunk of the clip as a (2, chunk) tensor on ``dev`` (zero
    past the clip's end; a mono clip duplicated on the device)."""
    n_in = audio_nc.shape[0]
    ring = _Ring((chunk, c_in), torch.float32) if dev.type == "cuda" else None
    zeros = torch.zeros((2, chunk), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        start = i * chunk
        n = max(0, min(chunk, n_in - start))
        if n == 0:
            yield zeros
            continue
        src = torch.from_numpy(audio_nc[start : start + n, :c_in])
        if ring is None:
            host = torch.zeros((chunk, c_in), dtype=torch.float32)
            host[:n] = src
            on_dev = host
        else:
            slot, host = ring.take()
            host[:n] = src
            host[n:] = 0.0
            on_dev = host.to(dev, non_blocking=True)
            ring.mark(slot)
        yield on_dev.T.expand(2, chunk)


def _conv_pass(audio_nc: np.ndarray, plan: _Plan, dev: torch.device):
    """Pass 1 → (mixed (2, n_total), its |max|) in fast mode, or (rest
    (2, n_total), late (2, n_total)) with exact air.

    Each chunk convolves at ``chunk + l − 1`` samples; the first ``l − 1``
    samples of the carried tail are added to the next chunk's output
    (overlap-add, exact for any chunk size).
    """
    chunk, n_chunks, scal, spec = plan.chunk, plan.n_chunks, plan.scal, plan.spec
    l = int(plan.kers.shape[-1])
    out_len_local = chunk + l - 1
    c_in = 1 if audio_nc.shape[1] == 1 else 2
    n_total = n_chunks * chunk
    dry_coef = scal.dry_factor * (1.0 - scal.dry_wet)
    kers = plan.kers[None]  # (1, K, l)
    chunks = _upload_chunks(audio_nc, c_in, chunk, n_chunks, dev)

    if plan.exact_air:
        rest_buf = torch.empty((2, n_total), dtype=torch.float32, device=dev)
        late_buf = torch.empty((2, n_total), dtype=torch.float32, device=dev)
        t_rest = torch.zeros((2, l - 1), dtype=torch.float32, device=dev)
        t_late = torch.zeros((2, l - 1), dtype=torch.float32, device=dev)
        for i, x in enumerate(chunks):
            conv = convolution.convolve_full(x[None], kers, out_len_local)[0]  # (K, 2, ·)
            if spec.early_on:
                early_full = conv[0] * scal.early_level
                late_full = conv[1]
            else:
                early_full = torch.zeros_like(conv[0])
                late_full = conv[0]
            early_wet = early_full[:, :chunk].clone()
            early_wet[:, : l - 1] += t_rest
            late_wet = late_full[:, :chunk].clone()
            late_wet[:, : l - 1] += t_late
            s = i * chunk
            rest_buf[:, s : s + chunk] = dry_coef * x + scal.dry_wet * early_wet
            late_buf[:, s : s + chunk] = late_wet
            t_rest, t_late = early_full[:, chunk:], late_full[:, chunk:]
        return rest_buf, late_buf

    gains = None
    if not plan.pairwise and spec.air_on and plan.kernel_is_late:
        # the air gain on the CHUNK's convolution grid (the fast-air rule)
        nfft = convolution.fast_fft_length(out_len_local)
        air = filters.air_absorption_gain(nfft, spec.rate, scal.air_absorption)[0]
        gains = torch.stack(
            [air if late else torch.ones_like(air) for late in plan.kernel_is_late]
        )[None]
    levels = [scal.early_level if not late else scal.late_level for late in plan.kernel_is_late]
    weights = torch.stack(levels, dim=1) if levels else None  # (1, K)
    mixed_buf = torch.empty((2, n_total), dtype=torch.float32, device=dev)
    tail = torch.zeros((2, l - 1), dtype=torch.float32, device=dev)
    gmax = torch.zeros((), dtype=torch.float32, device=dev)
    for i, x in enumerate(chunks):
        if plan.pairwise:
            wet_full = convolution.convolve_pairwise(x[None], plan.kers, out_len_local)[0]
        elif weights is not None:
            wet_full = convolution.convolve_combined(
                x[None], kers, weights, out_len_local, kernel_gains=gains
            )[0]
        else:
            # dry only: no FFT at all
            wet_full = torch.zeros((2, out_len_local), dtype=torch.float32, device=dev)
        wet = wet_full[:, :chunk].clone()
        wet[:, : l - 1] += tail
        tail = wet_full[:, chunk:]
        mixed = dry_coef * x + scal.dry_wet * wet
        mixed_buf[:, i * chunk : (i + 1) * chunk] = mixed
        gmax = torch.maximum(gmax, mixed.abs().amax())
    return mixed_buf, gmax


def _finish_pass(buf: torch.Tensor, gmax: torch.Tensor, scal: pipeline.MixScalars,
                 spec: pipeline.StaticSpec) -> torch.Tensor:
    """Pass 2 over the whole (2, n_total) buffer → (channels, n_total)."""
    mixed = torch.where(gmax < 1e-9, 0.0, buf * torch.where(gmax > 1.0, 1.0 / gmax, 1.0))
    six = spatial.apply_pan(mixed[None], spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos))
    six = filters.conditional_peak_normalize(six)
    out = spatial.map_layout(six, spec.layout, spec.rate, scal.z_pos)
    # the single-shot graph's buffers end at len_out, so map_layout's 12 and
    # 18 ms delays trim there; here they spill past it, into the padding.
    # Zero the spill so that the last normalize and the meter see the same
    # samples
    out[..., spec.len_out :] = 0.0
    return filters.conditional_peak_normalize(out)[0]


def _render_on_device(audio_nc: np.ndarray, plan: _Plan, dev: torch.device, stage=None):
    """Passes 1 and 2 (and the filters between) → the (channels, n_total)
    output on the device.  ``stage(name)``, when given, is called after
    each stage ("pass1", "filters", "pass2") — a hook for timing."""
    mark = stage or (lambda name: None)
    spec, scal = plan.spec, plan.scal
    if plan.exact_air:
        rest_buf, late_buf = _conv_pass(audio_nc, plan, dev)
        mark("pass1")
        late_buf = air_absorption_streaming(late_buf, spec.len_out, spec.rate, scal.air_absorption)
        mixed_buf = rest_buf + scal.dry_wet * scal.late_level * late_buf
        del rest_buf, late_buf
        gmax = mixed_buf.abs().amax()  # the post-mix peak, as in the exact graph
    else:
        mixed_buf, gmax = _conv_pass(audio_nc, plan, dev)
        mark("pass1")
    if spec.eq_on:
        # mix → EQ → normalize, the single-shot order: the normalization
        # keys on the post-EQ peak
        mixed_buf = shelf_eq_streaming(
            mixed_buf, spec.len_out, spec.rate, scal.bass_gain, scal.treble_gain
        )
        gmax = mixed_buf.abs().amax()
    mark("filters")
    out = _finish_pass(mixed_buf, gmax, scal, spec)
    mark("pass2")
    return out


def _download(out_cn: torch.Tensor, len_out: int, chunk: int) -> np.ndarray:
    """(C, n_total) on the device → (len_out, C) host array.  From a card it
    comes down a chunk at a time through the page-locked ring: chunk i+1's
    copy runs while chunk i is copied out of its buffer."""
    channels = int(out_cn.shape[0])
    result = torch.empty((len_out, channels), dtype=out_cn.dtype).numpy()
    if out_cn.device.type != "cuda":
        result[:] = out_cn[:, :len_out].T.numpy()
        return result
    ring = _Ring((chunk, channels), out_cn.dtype)
    pending = {}  # slot → (start, n) whose copy is in flight
    for start in range(0, len_out, chunk):
        n = min(chunk, len_out - start)
        slot, host = ring.take()  # waits for this slot's previous copy
        if slot in pending:
            s0, n0 = pending.pop(slot)
            result[s0 : s0 + n0] = host[:n0].numpy()
        host[:n].copy_(out_cn[:, start : start + n].T, non_blocking=True)
        ring.mark(slot)
        pending[slot] = (start, n)
    for slot, (s0, n0) in sorted(pending.items(), key=lambda kv: kv[1][0]):
        ring.events[slot].synchronize()
        result[s0 : s0 + n0] = ring.bufs[slot][:n0].numpy()
    return result


def render_streaming(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    seed: int = 0,
    chunk_seconds: float = DEFAULT_CHUNK_SECONDS,
    with_metrics: bool = False,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    return_output: bool = True,
    pcm16_output: bool = False,
    fast_filters: bool = True,
    device="cuda",
):
    """Render one long clip in chunks → (len_out, channels) float32.

    Any EQ gains, any layout, an internal hall or an external IR
    (``external_ir`` (samples, 2) at ``external_ir_rate``).  ``chunk_seconds``
    bounds the per-chunk FFT size; the result does not depend on it (the
    overlap-add is exact).

    ``fast_filters=False`` runs the reference's exact-length air transform
    (raytracer_studio.py:310-336) over the separated late stream instead of
    the air gain on each chunk's convolution grid (≤ ~2e-4 deviation, inside
    the 1e-3 contract), matching the single-shot exact render to float32
    round-off.

    ``return_output=False`` (requires ``with_metrics``) returns
    ``(None, metrics)`` without copying the result down.

    ``pcm16_output=True`` quantizes to the 16-bit output contract on the
    device (``pipeline.quantize_pcm16``) and returns int16, equal bit for bit
    to quantizing the float32 result on the host.  Metrics always measure
    the float signal.

    ``device``: "cuda" (the default) needs a card and raises without one;
    "cpu" runs the plain path.
    """
    if not return_output and not with_metrics:
        raise ValueError("return_output=False requires with_metrics=True")
    chunk_seconds = float(chunk_seconds)
    if not math.isfinite(chunk_seconds) or chunk_seconds <= 0:
        raise ValueError(
            f"chunk_seconds must be a positive finite number (got {chunk_seconds})"
        )
    dev = ensure_device(device)
    audio_nc = np.asarray(audio, dtype=np.float32)
    if audio_nc.ndim == 1:
        audio_nc = audio_nc[:, None]
    audio_nc = audio_nc[:, :2]
    plan = _plan(audio_nc, rate, p, seed, chunk_seconds, with_metrics, external_ir,
                 external_ir_rate, fast_filters, dev)
    out_cn = _render_on_device(audio_nc, plan, dev)
    len_out = plan.spec.len_out
    metrics = _streaming_metrics(out_cn, int(rate), len_out, plan.chunk, plan.n_chunks) \
        if with_metrics else None
    if not return_output:
        return None, metrics
    if pcm16_output:
        out_cn = pipeline.quantize_pcm16(out_cn)
    result = _download(out_cn, len_out, plan.chunk)
    return (result, metrics) if with_metrics else result


def _block_index(len_out: int, rate: int, chunk: int, n_chunks: int):
    """Gating-block bounds grouped per chunk (host) → (number of blocks J,
    bound slots in chunk order, their offsets inside their chunk, where each
    chunk's run starts).  Bound k lies in chunk (k − 1) // chunk; the bound 0
    lies in none and keeps energy 0."""
    lo, hi, jblocks = _block_bounds(len_out, rate)
    if jblocks <= 0:
        return 0, np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(n_chunks + 1, np.int64)
    bounds = np.concatenate([lo[:jblocks], hi[:jblocks]]).astype(np.int64)
    inside = np.nonzero(bounds > 0)[0]
    owner = (bounds[inside] - 1) // chunk
    order = np.argsort(owner, kind="stable")
    slots = inside[order]
    offsets = bounds[slots] - owner[order] * chunk  # in (0, chunk]
    starts = np.searchsorted(owner[order], np.arange(n_chunks + 1))
    return jblocks, slots, offsets, starts


def _streaming_metrics(out_cn: torch.Tensor, rate: int, len_out: int, chunk: int,
                       n_chunks: int) -> dict:
    """The chunked BS.1770 meter over the (C, n_total) output buffer → LUFS,
    sample peak (``true_peak_dbfs``, the reference's name) and RMS in dBFS.

    Per chunk: the mean of the first two channels through the K-weighting
    FIR with the carried tail, its energy prefix from the chunk's start
    (float64), and each gating-block bound in the chunk read from it plus
    the running prefix (float64, on the device); the peaks and the sum of
    squares run along.  One host read at the end.
    """
    dev = out_cn.device
    n_ch = int(out_cn.shape[0])
    fir = ir_synth.to_device(k_weighting_fir(rate).astype(np.float32), dev)
    fir_len = int(fir.shape[0])
    nfft = convolution.fast_fft_length(chunk + fir_len - 1)
    fir_f = torch.fft.rfft(fir, n=nfft)
    jblocks, slots, offsets, starts = _block_index(len_out, rate, chunk, n_chunks)
    slots_t = ir_synth.to_device(slots, dev)
    offsets_t = ir_synth.to_device(offsets, dev)

    energies = torch.zeros(2 * jblocks, dtype=torch.float64, device=dev)
    prefix = torch.zeros((), dtype=torch.float64, device=dev)
    kw_tail = torch.zeros(fir_len - 1, dtype=torch.float32, device=dev)
    peak = torch.zeros((), dtype=torch.float32, device=dev)
    mono_peak = torch.zeros((), dtype=torch.float32, device=dev)
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(n_chunks):
        out_chunk = out_cn[:, i * chunk : (i + 1) * chunk]
        mono = 0.5 * (out_chunk[0] + out_chunk[1])
        conv = torch.fft.irfft(torch.fft.rfft(mono, n=nfft) * fir_f, n=nfft)
        kw_chunk = conv[:chunk].clone()
        kw_chunk[: fir_len - 1] += kw_tail
        kw_tail = conv[chunk : chunk + fir_len - 1]
        cums = torch.nn.functional.pad(torch.cumsum(kw_chunk.double().square(), 0), (1, 0))
        a, b = int(starts[i]), int(starts[i + 1])
        if b > a:
            energies[slots_t[a:b]] = prefix + cums[offsets_t[a:b]]
        prefix = prefix + cums[-1]
        peak = torch.maximum(peak, out_chunk.abs().amax())
        mono_peak = torch.maximum(mono_peak, mono.abs().amax())
        sq = sq + out_chunk.double().square().sum()

    if jblocks > 0:
        z = (energies[jblocks:] - energies[:jblocks]) / (kw.BLOCK_SECONDS * rate)
        one = torch.ones(1, dtype=torch.float64, device=dev)
        lufs_t = gated_loudness_from_blocks(z[None, :], one).to(torch.float64)
    else:
        lufs_t = torch.tensor(-math.inf, dtype=torch.float64, device=dev)
    lufs, peak_v, mono_v, sq_v = torch.stack(
        [lufs_t, peak.double(), mono_peak.double(), sq]
    ).tolist()
    if mono_v < 1e-6:
        lufs = float("-inf")
    peak_db = 20.0 * math.log10(peak_v) if peak_v > 1e-15 else float("-inf")
    rms = math.sqrt(sq_v / (len_out * n_ch)) if len_out else 0.0
    rms_db = 20.0 * math.log10(rms) if rms > 1e-15 else float("-inf")
    return {"lufs": lufs, "true_peak_dbfs": peak_db, "rms_dbfs": rms_db}
