"""Tracing and timing harness — port of ``audio_raytracing_studio_tpu/utils/profiling.py``
in PyTorch's idiom.

- ``trace_span(name, device=None)``: a named span of the program, recorded
  only while a torch profiler is on (``profiler_session`` or any
  ``torch.profiler.profile``); otherwise it costs one check of the
  profiler's flag and does nothing else.  When on, it opens a
  ``record_function`` range (so the span sits on the profiler's timeline,
  on the clock of the device activity), an NVTX range on a card, and adds
  its host interval and, for a CUDA ``device``, its stream time to an
  in-memory table per span name: ``span_table()``.  ``counter_add`` /
  ``counters()`` keep counts in the same store; ``reset_spans()`` empties it.
- ``profiler_session(log_dir)``: ``torch.profiler.profile`` over the CPU
  and, where there is a card, CUDA activities, exported as a Chrome trace
  into ``log_dir`` — the operator's trace exporter (the spans are on inside it).
- ``time_call``: steady-state host-clock timing of a call, synchronized
  with the card after each call (the JAX version's scalar readback was a
  workaround for a TPU runtime whose ``block_until_ready`` returned early).

The JAX module's ``enable_compilation_cache`` and ``cpu_test_cache_dir``
have no counterpart: eager PyTorch compiles nothing per shape, and the one
build cache the port has is that of its CUDA kernels (``utils.kernels``,
keyed on the source's hash).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def spans_on() -> bool:
    """Whether a torch profiler is on, and with it the program's spans (a
    plain bool the profiler sets on entry and clears on exit)."""
    return _autograd_profiler._is_profiler_enabled


def trace_span(name: str, device=None):
    """A named span of the program around the block; see the module's
    docstring.  ``device``: the device the block enqueues its work on —
    when it is a CUDA device, the span also records a pair of CUDA events
    on that device's current stream, whose interval is the span's stream
    time: from the stream reaching the span's first enqueued work to its
    finishing the last.  With another stream busy beside it, a stage's
    stream time holds its share of the SMs, not its time alone."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


class _Span:
    """One call of a span while the profiler is on."""

    __slots__ = ("name", "stream", "start", "end", "parent", "t0", "child_ns", "_range")

    def __init__(self, name: str, device):
        self.name = name
        dev = None if device is None else torch.device(device)
        self.stream = torch.cuda.current_stream(dev) if dev is not None and dev.type == "cuda" else None

    def __enter__(self):
        _RECORDER.fold(wait=False)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
        stack = _RECORDER.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        if self.stream is not None:
            self.start = _RECORDER.event(self.stream)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        host_ns = time.perf_counter_ns() - self.t0
        if self.stream is not None:
            self.end = _RECORDER.event(self.stream)
            self.end.record(self.stream)
        _RECORDER.stack().pop()
        if self.parent is not None:
            self.parent.child_ns += host_ns
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        _RECORDER.close(self, host_ns)


def _new_row() -> dict:
    return {"calls": 0, "host_s": 0.0, "host_self_s": 0.0, "stream_s": None,
            "stream_self_s": None, "parents": {}}


class _Recorder:
    """Per-name aggregates of the spans, counters, and the CUDA event pairs
    not yet folded in.  Render threads (the serving worker and completer
    among them) record concurrently, so every change happens under one
    lock; each thread keeps its own stack of open spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._rows: Dict[str, dict] = {}
        self._counters: Dict[str, float] = {}
        # (name, parent name when on the same stream, start, end, device
        # index), in the order the spans closed; folded once ``end`` has
        # completed, so its length follows the work in flight, not the
        # length of the run
        self._pending: deque = deque()
        # folded events per device, recorded again by later spans: creating
        # and destroying a CUDA event costs more than recording one
        self._free: Dict[int, list] = {}

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _row(self, name: str) -> dict:
        row = self._rows.get(name)
        if row is None:
            row = self._rows[name] = _new_row()
        return row

    def event(self, stream) -> "torch.cuda.Event":
        """A timing event for ``stream``'s device: a folded one, or a new one."""
        with self._lock:
            free = self._free.get(stream.device_index)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def close(self, span: _Span, host_ns: int) -> None:
        parent = span.parent.name if span.parent is not None else None
        with self._lock:
            row = self._row(span.name)
            row["calls"] += 1
            row["host_s"] += host_ns * 1e-9
            row["host_self_s"] += (host_ns - span.child_ns) * 1e-9
            row["parents"][parent] = row["parents"].get(parent, 0) + 1
            if span.stream is not None:
                same = span.parent is not None and span.parent.stream == span.stream
                self._pending.append((span.name, parent if same else None,
                                      span.start, span.end, span.stream.device_index))

    def fold(self, wait: bool) -> None:
        """Fold the completed event pairs into the table, oldest first,
        stopping at the first still running (``wait``: wait for each)."""
        with self._lock:
            while self._pending:
                name, parent, start, end, index = self._pending[0]
                if wait:
                    end.synchronize()
                elif not end.query():
                    return
                self._pending.popleft()
                seconds = start.elapsed_time(end) * 1e-3
                self._free.setdefault(index, []).extend((start, end))
                row = self._row(name)
                row["stream_s"] = (row["stream_s"] or 0.0) + seconds
                row["stream_self_s"] = (row["stream_self_s"] or 0.0) + seconds
                if parent is not None:
                    up = self._row(parent)
                    up["stream_self_s"] = (up["stream_self_s"] or 0.0) - seconds

    def table(self) -> Dict[str, dict]:
        self.fold(wait=True)
        with self._lock:
            return {name: {**row, "parents": dict(row["parents"])}
                    for name, row in self._rows.items()}

    def counter_add(self, name: str, n: float) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._counters.clear()
            self._pending.clear()
            self._free.clear()


_RECORDER = _Recorder()


def span_table() -> Dict[str, dict]:
    """Every span recorded so far, by name, once the pending CUDA events
    have completed: ``calls``; ``host_s`` and ``host_self_s`` (host seconds,
    and less the host time of the spans opened inside it); ``stream_s`` and
    ``stream_self_s`` (stream seconds, and less the stream time of the spans
    inside it on the same stream; both None for a span that recorded no
    events); ``parents``, the name of the enclosing span (None at the top)
    → calls."""
    return _RECORDER.table()


def counter_add(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name``."""
    _RECORDER.counter_add(name, n)


def counters() -> Dict[str, float]:
    """Every counter added to so far."""
    return _RECORDER.counters()


def reset_spans() -> None:
    """Forget every span, pending event and counter recorded so far."""
    _RECORDER.reset()


@contextlib.contextmanager
def profiler_session(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the block into ``log_dir`` as a Chrome trace
    (``trace.json``; open it in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass(frozen=True)
class TimingResult:
    name: str
    iterations: int
    seconds_per_call: float
    seconds_median: float
    seconds_min: float

    def realtime_factor(self, audio_seconds: float) -> float:
        return audio_seconds / self.seconds_per_call

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.seconds_per_call * 1e3:.2f} ms/call "
            f"(median {self.seconds_median * 1e3:.2f}, min {self.seconds_min * 1e3:.2f}, "
            f"n={self.iterations})"
        )


def _sync(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(
    fn: Callable,
    *args,
    name: str = "fn",
    iterations: int = 5,
    warmup: int = 1,
    device="cuda",
    **kwargs,
) -> TimingResult:
    """Steady-state timing of ``fn(*args, **kwargs)`` on ``device``.

    Warms up first (cuFFT plans, the allocator, a first kernel build), then
    measures the host clock around each call, which ends in
    ``torch.cuda.synchronize(device)`` on a card: PyTorch returns before the
    device has finished, so a clock without it measures the enqueue.
    """
    for _ in range(max(1, warmup)):
        fn(*args, **kwargs)
        _sync(device)
    samples = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync(device)
        samples.append(time.perf_counter() - t0)
    return TimingResult(
        name=name,
        iterations=iterations,
        seconds_per_call=sum(samples) / len(samples),
        seconds_median=statistics.median(samples),
        seconds_min=min(samples),
    )
