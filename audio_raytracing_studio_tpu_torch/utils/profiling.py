"""Tracing and timing harness — port of ``audio_raytracing_studio_tpu/utils/profiling.py``
in PyTorch's idiom.

- ``trace_span(name)``: a named region on the profiler's timeline
  (``torch.profiler.record_function``), plus an NVTX range on a card.
- ``profiler_session(log_dir)``: ``torch.profiler.profile`` over the CPU
  and, where there is a card, CUDA activities, exported as a Chrome trace
  into ``log_dir``.
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
import time
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named region for the profiler timeline (and NVTX on a card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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
