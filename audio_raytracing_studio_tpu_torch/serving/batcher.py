"""Dynamic micro-batching render service — port of
``audio_raytracing_studio_tpu/serving/batcher.py``.

One render request at a time leaves the card mostly idle: its throughput
comes from batched renders.  ``RenderService`` queues concurrent requests,
buckets them by shape, and dispatches each bucket as one
``parallel.sharding.render_batch`` call:

* Concurrent ``RenderJob``s enter one queue.
* A worker thread groups them by **batch key** — everything that sets the
  shapes of the render: sample rate, half-second length bucket
  (``sharding.bucket_length``), IR geometry (hall type, room size, z
  position), target layout, filter mode, metrics flag.  Value-only
  parameters (material, diffusion, air, positions, mix, EQ gains, seeds)
  sweep freely **inside** one batch — ``render_batch`` widens their stage
  flags batch-wide and keeps per-clip semantics through per-clip scalars.
* A group dispatches as ONE ``render_batch`` call when it reaches
  ``max_batch`` or its oldest job has waited ``max_wait_ms``.  Jobs that
  arrive while the card renders batch *i* accumulate into batch *i+1*, so
  the batch size adapts to load with no tuning.
* Dispatch is PIPELINED (``pipeline_depth``): the worker stacks, uploads and
  enqueues batch *i+1* on a CUDA stream of its own while batch *i*'s result
  is still on its way down, and a completer thread waits for batch *i*'s
  event and trims it (``render_batch(async_results=True)``).  A bounded
  hand-off queue keeps the groups in flight finite: ``pipeline_depth − 1``
  waiting, one with the completer, and the one the worker has just enqueued.
* Each job's output is trimmed back to its true span
  (``clip_len + ir_len − 1``) and, with metrics on, metered on the device
  against the true span (masked meter), never the bucket padding.
* A clip longer than ``streaming_threshold_s`` is a group of its own (key
  ``("streaming", uuid)``) and renders through the chunked
  ``parallel.streaming.render_streaming`` on its group's stream (no
  whole-clip convolution FFT, no padded batch).

Padding semantics: zero-padding a clip to its length bucket is exact for
every linear-convolution stage, and the exact air filter's smooth gain ramp
is insensitive to it at half-second granularity.  The circular shelf EQ is
NOT: its brick-wall masks ring over the whole circle, so ``render_batch``
EQs every padded EQ-on clip at its true length
(``ops.filters.apply_shelf_eq_dynamic``, equal to the unpadded solo render).
That EQ is a Bluestein at the power of two of the bucket's output length
with each clip's true length as a per-row scalar, so its cuFFT plans depend
on the bucket and the batch size, never on the upload lengths.  The service
still caps the plan cache (``FFT_PLAN_CACHE_MAX``: buckets, batch sizes and
external IRs each add plans) and reports its size in ``stats()``.

In this eager runtime the half-second bucket and the power-of-two batch
sizes are batching keys that bound the cuFFT plan set and the allocator's
block sizes; nothing is compiled per shape.

Over a device mesh (``device_mesh``) each group's padded batch is rounded
up to a multiple of the mesh's data axis and ``render_batch`` splits it
over the shards: the group then spans every shard's stream, and its
page-locked staging stays referenced until ``fetch()`` has waited for every
shard's copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import queue
import threading
import time
import uuid
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import pipeline
from ..parallel import mesh as meshlib
from ..parallel import sharding
from ..params import RenderParams
from ..utils.runtime import ensure_device, fft_plan_cache

log = logging.getLogger("ars_torch.serving")

_STOP = object()

# cuFFT plans PyTorch may keep for the service's card (its default is 4096).
# Every distinct (length, batch, type) is a plan: each bucket and batch size
# makes its own, the padded EQ's included (it keys on the bucket, not on
# the clips' true lengths).
FFT_PLAN_CACHE_MAX = 256


@dataclasses.dataclass
class RenderJob:
    """One render request: a clip plus the 16-parameter surface."""

    audio: np.ndarray  # (N,) or (N, C) float32
    rate: int
    params: RenderParams = dataclasses.field(default_factory=RenderParams)
    seed: int = 0
    with_metrics: bool = False
    external_ir: Optional[np.ndarray] = None  # (L, 2) when use_external_ir
    external_ir_rate: Optional[int] = None


@dataclasses.dataclass
class RenderResult:
    """Trimmed render output (true span ``clip_len + ir_len − 1``)."""

    audio: np.ndarray  # (len_out, channels) float32 (int16 when pcm16)
    rate: int
    metrics: Optional[dict] = None  # lufs / true_peak_dbfs / rms_dbfs


@dataclasses.dataclass
class _Item:
    job: RenderJob
    future: Future
    key: tuple
    clip: np.ndarray  # (n_true, 1 or 2) float32: the job's audio, not copied
    n_bucket: int
    prepared_ir: Optional[np.ndarray]  # rate-matched (L, 2), external mode
    nbytes: int = 0  # host bytes this item holds until its future resolves


def _untrack_result(svc_ref, nbytes: int):
    """weakref.finalize callback: a RenderResult's audio array was collected.

    Module-level, with a weak reference to the service, so the finalizers
    never keep a stopped RenderService alive through its outstanding results.
    """
    svc = svc_ref()
    if svc is not None:
        with svc._lock:
            svc._retained_result_bytes -= nbytes
            svc._retained_results -= 1


def memory_stats(device="cpu") -> Dict[str, Any]:
    """Process and runtime memory snapshot, merged into ``stats()``.

    ``rss_mb`` is the whole process.  For a CUDA ``device``:
    ``device_allocated_mb`` / ``device_reserved_mb`` are PyTorch's caching
    allocator (live tensors / blocks it holds), ``fft_plans`` and
    ``fft_plans_max`` the cuFFT plan cache of that card, ``pinned_mb`` the
    page-locked host memory PyTorch's host allocator holds for this process
    (the staging buffers of uploads and results, those it keeps for reuse
    included).  On the CPU they read 0.
    """
    out: Dict[str, Any] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_mb"] = round(float(line.split()[1]) / 1024.0, 1)
                    break
    except OSError:
        pass
    dev = torch.device(device)
    out.update(device_allocated_mb=0.0, device_reserved_mb=0.0, fft_plans=0,
               fft_plans_max=0, pinned_mb=0.0)
    if dev.type == "cuda":
        plans = fft_plan_cache(dev)
        out.update(
            device_allocated_mb=round(torch.cuda.memory_allocated(dev) / 1e6, 1),
            device_reserved_mb=round(torch.cuda.memory_reserved(dev) / 1e6, 1),
            fft_plans=int(plans.size),
            fft_plans_max=int(plans.max_size),
            pinned_mb=round(
                torch.cuda.host_memory_stats().get("allocated_bytes.current", 0) / 1e6, 1
            ),
        )
    return out


class RenderService:
    """Queue + micro-batcher over ``parallel.sharding.render_batch``.

    Parameters
    ----------
    max_batch:    dispatch a group as soon as it holds this many jobs.
                  Groups are zero-padded up to power-of-two size buckets
                  capped at max_batch (see ``_batch_pad``) so the set of
                  batch sizes stays O(log max_batch) whatever sizes arrival
                  timing produces; pad rows never come down.
    max_wait_ms:  dispatch a partial group once its oldest job has waited
                  this long (latency bound under light load).
    device_mesh:  optional ``parallel.mesh.Mesh`` — the padded batch also
                  rounds up to a multiple of its data axis and renders
                  split over the shards (``render_batch(device_mesh=...)``);
                  its devices must be of ``device``'s type.  A mesh's
                  shards have one stream each, which every group shares:
                  with a mesh, successive groups overlap across shards, not
                  across the service's own streams.
    ir_backend:   "bank" (the fused RIR bank: the CUDA kernels on a card) or
                  "jnp" (the plain per-clip ``synthesize``, for comparison).
    fast_filters: conv-grid air absorption (≤2e-4 deviation) instead of the
                  reference's exact-length transform.
    pcm16_output: quantize to int16 on the device (halves the copy down).
    streaming_threshold_s: clips longer than this route to the chunked
                  streaming renderer (``parallel.streaming``)
                  as singleton groups, with the service's ``fast_filters``
                  and ``pcm16_output``; None disables the routing.
    chunk_seconds: streaming chunk size for routed long jobs.
    max_queued:   submit() raises RuntimeError once this many jobs are
                  waiting (backpressure — each queued job holds its whole
                  decoded clip in host RAM; HTTP maps this to 503).
    pipeline_depth: number of dispatched groups in flight at once, each on a
                  CUDA stream of its own.  2 (the default) overlaps group
                  *i*'s copy down and trim with group *i+1*'s stacking,
                  upload and render; 1 is the fully serial worker.  Each
                  in-flight group holds its device buffers and page-locked
                  staging until its copy down completes.  The worker
                  enqueues a group's render *before* it waits for a free
                  slot in the completer's queue (``depth − 1`` slots), so
                  up to ``depth + 1`` groups hold such memory at once: one
                  with the completer, ``depth − 1`` queued, one dispatched
                  and waiting for its slot (at depth 1 the worker completes
                  its own group: one).  Size the card's and the host's
                  page-locked memory for ``depth + 1`` groups.
    device:       where the service renders; "cuda" (the default) needs a
                  card and raises here without one, "cpu" is the plain path.
    start:        spawn the worker immediately (tests pass False to stage
                  jobs deterministically before the first dispatch).
    """

    def __init__(
        self,
        *,
        max_batch: int = 16,
        max_wait_ms: float = 100.0,
        device_mesh=None,
        ir_backend: str = "bank",
        fast_filters: bool = False,
        pcm16_output: bool = False,
        streaming_threshold_s: Optional[float] = 600.0,
        chunk_seconds: float = 30.0,
        max_queued: int = 64,
        pipeline_depth: int = 2,
        device="cuda",
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        if max_queued < 1:
            raise ValueError(f"max_queued must be >= 1 (got {max_queued})")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1 (got {pipeline_depth})"
            )
        if ir_backend not in sharding.IR_BACKENDS:
            raise ValueError(
                f"ir_backend must be one of {sharding.IR_BACKENDS}, got {ir_backend!r}"
            )
        self.device = ensure_device(device)  # no card → raises before any job
        if device_mesh is not None:
            meshlib.check_mesh(device_mesh, self.device)
        self.device_mesh = device_mesh
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.ir_backend = ir_backend
        self.fast_filters = bool(fast_filters)
        self.pcm16_output = bool(pcm16_output)
        self.streaming_threshold_s = streaming_threshold_s
        self.chunk_seconds = float(chunk_seconds)
        self.max_queued = int(max_queued)
        self.pipeline_depth = int(pipeline_depth)
        # one stream per in-flight group: a group's upload, render and copy
        # down are ordered on its stream, and two groups' copies and kernels
        # may overlap on the card
        self._streams: List[Optional["torch.cuda.Stream"]] = [None]
        if self.device.type == "cuda":
            self._streams = [
                torch.cuda.Stream(self.device) for _ in range(self.pipeline_depth)
            ]
            devices = {self.device} if device_mesh is None else {
                d for row in device_mesh.devices for d in row}
            for dev in devices:
                plans = fft_plan_cache(dev)
                plans.max_size = min(int(plans.max_size), FFT_PLAN_CACHE_MAX)
        self._groups_dispatched = 0  # picks the next group's stream
        self._q: "queue.Queue" = queue.Queue()
        # dispatched groups whose results are still coming down; the bounded
        # put() is the worker's backpressure against the completer
        self._cq: Optional["queue.Queue"] = (
            queue.Queue(maxsize=self.pipeline_depth - 1)
            if self.pipeline_depth > 1
            else None
        )
        self._lock = threading.Lock()
        self._batch_sizes: List[int] = []
        self._jobs_done = 0
        self._jobs_failed = 0
        self._dispatch_s = 0.0  # host stacking + enqueueing upload and render
        self._fetch_s = 0.0  # waiting for the copy down + host trim
        # host-memory accounting: the serving layer can say where its bytes are
        self._inflight_input_bytes = 0  # clips+IRs of unresolved jobs
        self._retained_result_bytes = 0  # result arrays callers still hold
        self._retained_results = 0
        # cumulative copy volume in each direction
        self._dispatched_input_bytes_total = 0
        self._fetched_result_bytes_total = 0
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        if start:
            self.start()

    # --- lifecycle ---
    def start(self) -> "RenderService":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="ars-serving-batcher", daemon=True
            )
            self._thread.start()
        if self._cq is not None and (
            self._completer is None or not self._completer.is_alive()
        ):
            self._completer = threading.Thread(
                target=self._completer_loop,
                name="ars-serving-completer",
                daemon=True,
            )
            self._completer.start()
        return self

    def stop(self, timeout: float = 60.0):
        """Drain: queued jobs still dispatch, in-flight groups still come
        down, then both threads exit.  Jobs submitted after (or racing)
        stop() fail with RuntimeError instead of hanging their futures."""
        self._stopped = True
        if self._thread is None:
            self._flush_orphans()
            return
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.warning(
                "batcher worker still busy after %.0fs stop timeout "
                "(mid-dispatch render?) — leaving the daemon thread to finish",
                timeout,
            )
            return
        self._thread = None
        if self._completer is not None:
            # the worker has exited, so every dispatched group is already
            # queued here — _STOP lands after the last of them
            self._cq.put(_STOP)
            self._completer.join(timeout=timeout)
            if self._completer.is_alive():
                log.warning(
                    "batcher completer still fetching after %.0fs stop "
                    "timeout — leaving the daemon thread to finish",
                    timeout,
                )
                return
            self._completer = None
        self._flush_orphans()

    def _flush_orphans(self):
        """Fail any item that slipped into the queue after the worker left."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                if item.future.set_running_or_notify_cancel():
                    item.future.set_exception(
                        RuntimeError("render service stopped")
                    )
                self._release_inputs([item])

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sizes = list(self._batch_sizes)
            out = {
                "batches": len(sizes),
                "batch_sizes": sizes,
                "jobs_done": self._jobs_done,
                "jobs_failed": self._jobs_failed,
                "queued": self._q.qsize(),
                "pipeline_depth": self.pipeline_depth,
                # per-phase totals: where the wall-clock goes.  dispatch =
                # host stacking, staging and enqueueing on the worker; fetch
                # = waiting for the copy down, then the trim.  With
                # pipelining these overlap, so their sum can exceed the
                # elapsed serving time.
                "dispatch_s": round(self._dispatch_s, 3),
                "fetch_s": round(self._fetch_s, 3),
                # clips+IRs held by jobs whose futures have not resolved
                "inflight_input_bytes": self._inflight_input_bytes,
                # result arrays delivered to callers and still alive (each
                # owns exactly its trimmed bytes — never a batch-buffer view)
                "retained_result_bytes": self._retained_result_bytes,
                "retained_results": self._retained_results,
                # cumulative bytes copied up (pad rows and bucket padding
                # included) and down (the real rows' buffers)
                "dispatched_input_bytes_total": (
                    self._dispatched_input_bytes_total
                ),
                "fetched_result_bytes_total": (
                    self._fetched_result_bytes_total
                ),
            }
        out.update(memory_stats(self.device))
        return out

    # --- submission ---
    def submit(self, job: RenderJob) -> "Future[RenderResult]":
        """Validate, key, and enqueue a job.  Invalid jobs raise HERE
        (fail-fast ValueError), never poison the worker; an overloaded or
        stopped service raises RuntimeError (HTTP: 503).

        A float32 ``job.audio`` is kept, not copied: the queued job holds a
        view of the caller's array until its group is stacked.  The caller
        must not write to that array until the future resolves — a write
        before then changes what is rendered.  (Arrays of another type are
        converted, which copies them.)"""
        if self._stopped:
            raise RuntimeError("render service stopped")
        if self._q.qsize() >= self.max_queued:
            raise RuntimeError(
                f"render service overloaded ({self.max_queued} jobs queued) — retry later"
            )
        item = self._prepare(job)
        item.nbytes = item.clip.nbytes + (
            item.prepared_ir.nbytes if item.prepared_ir is not None else 0
        )
        fut: "Future[RenderResult]" = Future()
        item.future = fut
        with self._lock:
            self._inflight_input_bytes += item.nbytes
        self._q.put(item)
        return fut

    def _release_inputs(self, items: List["_Item"]):
        """Input accounting: these items' futures just resolved (result,
        error, or cancellation) — their clips/IRs are no longer held by
        the service pipeline."""
        freed = sum(it.nbytes for it in items)
        if freed:
            with self._lock:
                self._inflight_input_bytes -= freed

    def render(self, job: RenderJob, timeout: Optional[float] = None) -> RenderResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(job).result(timeout=timeout)

    # --- internals ---
    def _prepare(self, job: RenderJob) -> _Item:
        audio = np.asarray(job.audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[:, None]
        if audio.ndim != 2 or audio.shape[0] < 1:
            raise ValueError(
                f"job audio must be (N,) or (N, C) with N >= 1, got {audio.shape}"
            )
        rate = int(job.rate)
        if rate <= 0:
            raise ValueError(f"job rate must be positive (got {job.rate})")
        if not isinstance(job.params, RenderParams):
            raise ValueError("job.params must be a RenderParams")
        # mono stays mono here (a view of the job's array, no copy on the
        # submitting thread); it is duplicated while the group is stacked
        clip = audio[:, :2]
        # EQ-on jobs bucket like everything else: render_batch EQs each
        # padded clip at its true length with plans keyed on the bucket
        n_bucket = sharding.bucket_length(clip.shape[0], rate)
        streaming = (
            self.streaming_threshold_s is not None
            and clip.shape[0] > self.streaming_threshold_s * rate
        )

        if job.params.use_external_ir:
            if job.external_ir is None:
                raise ValueError("use_external_ir=True requires job.external_ir")
            prepared = pipeline.prepare_external_ir(
                job.external_ir,
                int(job.external_ir_rate) if job.external_ir_rate else rate,
                rate,
            ).numpy()
            if streaming:
                # a singleton group; n_bucket = the true length, so the trim
                # keeps the whole len_out
                key = ("streaming", uuid.uuid4().hex)
                return _Item(job, None, key, clip, clip.shape[0], prepared)
            # jobs sharing the same prepared IR bytes may share one batch
            # (render_batch convolves the whole batch against ONE IR)
            ir_digest = hashlib.sha1(prepared.tobytes()).hexdigest()
            key = (
                "external", rate, n_bucket, job.params.target_layout,
                prepared.shape, ir_digest, bool(job.with_metrics),
            )
            return _Item(job, None, key, clip, n_bucket, prepared)

        if streaming:
            key = ("streaming", uuid.uuid4().hex)
            return _Item(job, None, key, clip, clip.shape[0], None)

        # shape-only derivation (render_batch rebuilds the full setup at
        # dispatch)
        spec, ir_shape = pipeline.build_internal_spec(
            job.params, rate, n_bucket, fast_filters=self.fast_filters
        )
        # value-driven stage flags (EQ on/off, air on/off, early/late levels)
        # are widened batch-wide by render_batch with exact per-clip
        # semantics — normalize them out of the key so such jobs batch
        neutral_spec = spec._replace(
            eq_on=False, air_on=False, early_on=False, late_on=False
        )
        key = ("internal", neutral_spec, ir_shape, bool(job.with_metrics))
        return _Item(job, None, key, clip, n_bucket, None)

    def _worker(self):
        pending: Dict[tuple, List[_Item]] = {}
        deadlines: Dict[tuple, float] = {}
        draining = False
        while True:
            item = None
            if not draining:
                timeout = None
                if deadlines:
                    timeout = max(0.0, min(deadlines.values()) - time.monotonic())
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    item = None
            else:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    item = None
            if item is _STOP:
                draining = True
                item = None
            if item is not None:
                group = pending.setdefault(item.key, [])
                group.append(item)
                deadlines.setdefault(item.key, time.monotonic() + self.max_wait_s)
                if len(group) >= self.max_batch:
                    deadlines.pop(item.key, None)
                    self._dispatch(pending.pop(item.key))
                # drop the bindings BEFORE blocking on the next get(): a
                # stale `group`/`item` held across an idle wait pins the
                # dispatched items → futures → results indefinitely
                del group, item
                continue
            # timeout path (or draining): flush due groups oldest-first
            now = time.monotonic()
            due = sorted(
                (d, k) for k, d in deadlines.items() if draining or d <= now
            )
            for _, k in due:
                deadlines.pop(k, None)
                self._dispatch(pending.pop(k))
            if draining and not pending and self._q.empty():
                return

    def _next_stream(self):
        """The stream of the next group (None on the CPU), in rotation: with
        depth d, group i+d follows group i on the same stream."""
        stream = self._streams[self._groups_dispatched % len(self._streams)]
        self._groups_dispatched += 1
        return stream

    def _dispatch(self, items: List[_Item]):
        # split by identity: comparing items (dataclasses holding arrays)
        # with == or `in` raises once a group mixes cancelled and live jobs
        live: List[_Item] = []
        cancelled: List[_Item] = []
        for it in items:
            (live if it.future.set_running_or_notify_cancel() else cancelled).append(it)
        self._release_inputs(cancelled)
        items = live
        if not items:
            return
        with self._lock:
            self._batch_sizes.append(len(items))
        t0 = time.monotonic()
        try:
            fetch, uploaded = self._render_group(items, self._next_stream())
        except Exception as e:  # noqa: BLE001 — job error, not worker death
            log.exception("batch of %d failed at dispatch", len(items))
            with self._lock:
                self._jobs_failed += len(items)
            for it in items:
                it.future.set_exception(e)
            self._release_inputs(items)
            return
        with self._lock:
            self._dispatch_s += time.monotonic() - t0
            self._dispatched_input_bytes_total += uploaded
        if self._cq is not None:
            # hand the fetch to the completer; blocks once pipeline_depth-1
            # groups already await theirs — that bound is what keeps the
            # in-flight device results and pinned buffers finite
            self._cq.put((items, fetch))
        else:
            self._complete(items, fetch)

    def _completer_loop(self):
        while True:
            entry = self._cq.get()
            if entry is _STOP:
                return
            self._complete(*entry)
            # drop the binding BEFORE blocking on the next get(): a loop
            # variable held across an idle wait pins the just-completed
            # batch's items → futures → results indefinitely
            del entry

    def _complete(self, items: List[_Item], fetch):
        """Wait for one dispatched group's copy down, trim it and resolve
        its futures."""
        t0 = time.monotonic()
        try:
            outs, metrics = fetch()
        except Exception as e:  # noqa: BLE001 — job error, not thread death
            log.exception("batch of %d failed at result fetch", len(items))
            with self._lock:
                self._jobs_failed += len(items)
            for it in items:
                it.future.set_exception(e)
            self._release_inputs(items)
            return
        n_bucket = items[0].n_bucket
        ir_tail = outs.shape[1] - n_bucket  # = ir_len − 1
        svc_ref = weakref.ref(self)
        results = []
        for it in items:
            real_len = it.clip.shape[0] + ir_tail
            audio = outs[len(results), :real_len]
            if items[0].key[0] != "streaming":
                # .copy(): the slice is a VIEW of the whole (batch, len_out,
                # ch) pinned buffer — one retained job result would pin the
                # entire batch's bytes, and page-locked ones at that (a
                # streamed job's result is an array of its own already)
                audio = audio.copy()
            with self._lock:
                self._retained_result_bytes += audio.nbytes
                self._retained_results += 1
            weakref.finalize(audio, _untrack_result, svc_ref, audio.nbytes)
            results.append(RenderResult(
                audio=audio,
                rate=int(it.job.rate),
                metrics=metrics[len(results)] if metrics is not None else None,
            ))
        with self._lock:
            self._fetch_s += time.monotonic() - t0
            self._fetched_result_bytes_total += outs.nbytes
        for it, result in zip(items, results):
            it.future.set_result(result)
        del results
        self._release_inputs(items)
        with self._lock:
            self._jobs_done += len(items)

    def bucket_sizes(self) -> List[int]:
        """The batch sizes this service dispatches at: powers of two capped
        at ``max_batch``, each rounded up to a multiple of the mesh's data
        axis — the fixed points of ``_batch_pad`` (every bucket pads to
        itself, also when the data axis is not a power of two).  This is the
        set ``warm()`` prepares."""
        raw = {1 << k for k in range(self.max_batch.bit_length())}
        raw = {b for b in raw if b <= self.max_batch} | {self.max_batch}
        if self.device_mesh is not None:
            d = self.device_mesh.shape[meshlib.DATA_AXIS]
            raw = {b + (-b) % d for b in raw}
        return sorted(raw)

    def warm(
        self, job: RenderJob, sizes: Optional[List[int]] = None
    ) -> List[int]:
        """Prepare the card for every batch-size bucket of ``job``'s
        signature before traffic arrives.

        Nothing is compiled per shape here; what a first render of a new
        (signature, batch size) pays is the kernel build (once per
        process), the cuFFT plans of its lengths and batch, and the
        allocator's first blocks on each of the service's streams.  ``warm``
        dispatches ONE template-filled batch per bucket on every stream,
        synchronously on the calling thread, and drops the results.  Call
        it before ``submit`` traffic — it does not coordinate with the
        worker's own dispatches.

        Returns the bucket sizes warmed.
        """
        item = self._prepare(job)
        if item.key[0] == "streaming":
            raise ValueError(
                "streaming-routed jobs have no batch buckets to warm "
                "(the streaming renderer keys on chunk shape, not batch)"
            )
        if sizes is None:
            sizes = self.bucket_sizes()
        else:
            sizes = sorted(
                {
                    b + self._batch_pad(b)
                    for b in (min(max(1, int(s)), self.max_batch) for s in sizes)
                }
            )
        for b in sizes:
            # the fetches (and with them the staging buffers the uploads
            # read) live until the bucket's streams have drained
            fetches = [self._render_group([item] * b, s) for s in self._streams]
            for stream in self._streams:
                if stream is not None:
                    stream.synchronize()
            if self.device_mesh is not None:
                self.device_mesh.synchronize()
            del fetches
        return sizes

    def _batch_pad(self, batch: int) -> int:
        """Pad count that rounds ``batch`` up to its size bucket.

        A group's size depends on arrival timing; unbucketed, traffic keeps
        meeting fresh batch sizes, each with cuFFT plans and allocator
        blocks of its own.  Buckets are powers of two capped at
        ``max_batch`` (e.g. {1,2,4,8,16,32,48} for max_batch=48): O(log
        max_batch) sizes in all, at most 2× zero-pad upload and render
        waste, and pad rows never come down — render_batch drops them on
        the device (``real_batch``).  A mesh's data axis still divides the
        result.  Pads to the smallest ``bucket_sizes()`` entry ≥ batch, so
        every bucket is a fixed point (d=3: bucket 3 stays 3, not 6).
        """
        for b in self.bucket_sizes():
            if b >= batch:
                return b - batch
        return 0  # batch > max_batch: dispatch grouping prevents it

    def _render_group(self, items: List[_Item], stream=None):
        """Stack one group and enqueue its upload, render and copy down on
        ``stream`` (the current stream when None; with a mesh, on the
        shards' streams).  Returns ``(fetch,
        uploaded_bytes)``; the zero-argument ``fetch()`` waits for the copy
        down and produces ``(outs, metrics)`` — on the completer thread in
        pipelined mode."""
        if items[0].key[0] == "streaming":
            return self._render_streaming(items[0], stream)
        n_bucket = items[0].n_bucket
        rate = int(items[0].job.rate)
        with_metrics = bool(items[0].job.with_metrics)
        batch = len(items)

        pad = self._batch_pad(batch)

        # stacked straight into page-locked memory (on a card): the upload
        # reads it in place, so it stays referenced until the group's fetch
        # (a group of mono jobs stays mono up to the device)
        channels = max(it.clip.shape[1] for it in items)
        clips = sharding.staging_clips(batch + pad, n_bucket, channels, self.device)
        for i, it in enumerate(items):
            n = it.clip.shape[0]
            clips[i, :n] = it.clip  # a mono clip among stereo ones broadcasts
            clips[i, n:] = 0.0
        clips[batch:] = 0.0
        param_list = [it.job.params for it in items]
        param_list += [param_list[-1]] * pad
        seeds = [int(it.job.seed) for it in items] + [0] * pad
        true_lens = [it.clip.shape[0] for it in items] + [n_bucket] * pad
        uploaded = clips.nbytes

        kwargs: Dict[str, Any] = dict(
            seeds=seeds,
            device_mesh=self.device_mesh,
            with_metrics=with_metrics,
            fast_filters=self.fast_filters,
            pcm16_output=self.pcm16_output,
            # always given: true lengths drive BOTH the masked meter and the
            # true-length EQ of padded EQ-on clips
            clip_lengths=true_lens,
            device=self.device,
        )
        if items[0].key[0] == "external":
            kwargs["external_ir"] = items[0].prepared_ir
            kwargs["external_ir_rate"] = rate  # already rate-matched
            uploaded += items[0].prepared_ir.nbytes
        else:
            kwargs["ir_backend"] = self.ir_backend

        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            fetch_raw = sharding.render_batch(
                clips, rate, param_list, async_results=True, real_batch=batch,
                **kwargs,
            )

        def fetch(_staged=clips):
            # pad rows were dropped on the device (real_batch) — only the
            # real jobs came down; ``_staged`` keeps the upload's source
            # alive until then
            result = fetch_raw()
            return result if with_metrics else (result, None)

        return fetch, uploaded

    def _render_streaming(self, it: _Item, stream=None):
        """One long job through ``parallel.streaming.render_streaming`` on
        ``stream``, here on the worker: it uploads, renders and copies down
        in chunks and returns host arrays, so ``fetch()`` only hands them
        out.  Returns ``(fetch, uploaded_bytes)`` like ``_render_group``."""
        from ..parallel.streaming import render_streaming

        job = it.job
        kwargs: Dict[str, Any] = dict(
            seed=int(job.seed),
            chunk_seconds=self.chunk_seconds,
            with_metrics=bool(job.with_metrics),
            pcm16_output=self.pcm16_output,
            fast_filters=self.fast_filters,
            device=self.device,
        )
        if it.prepared_ir is not None:
            kwargs["external_ir"] = it.prepared_ir
            kwargs["external_ir_rate"] = int(job.rate)  # already rate-matched
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            result = render_streaming(it.clip, int(job.rate), job.params, **kwargs)
        out, metrics = result if job.with_metrics else (result, None)
        streamed = (out[None], None if metrics is None else [metrics])
        return (lambda: streamed), it.nbytes
