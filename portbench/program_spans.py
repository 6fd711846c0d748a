"""The program's own spans and counters, for the readers of the per-layer
metrics that the port records itself.

``audio_raytracing_studio_tpu_torch.utils.profiling`` keeps them in memory
while a torch profiler is on, which in a run is the traced window alone:
``span_table()`` gives each span's calls, host seconds and, on a card,
stream seconds (CUDA events on the stream the span enqueued on), each also
less its child spans; ``counters()`` the counts.  A program that records
none (one older than its spans) reads as empty, and its readers return
None.

Stream time is not a stage's kernel time alone: with two batches in flight
the other stream's kernels share the SMs, so a stage's stream time reads
between 1x and about 2x its time alone.  It still falls when the stage gets
faster.
"""

from __future__ import annotations

from typing import Optional

import torch


def _profiling():
    try:
        from audio_raytracing_studio_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def table() -> dict:
    """``profiling.span_table()``, or {} where the program has none."""
    read = getattr(_profiling(), "span_table", None)
    return read() if read is not None else {}


def counters() -> dict:
    """``profiling.counters()``, or {} where the program has none."""
    read = getattr(_profiling(), "counters", None)
    return read() if read is not None else {}


def host_ms_per_call(name: str, less: Optional[str] = None) -> Optional[float]:
    """Host milliseconds per call of span ``name``, less those of span
    ``less`` over the same calls; None where either never ran."""
    spans = table()
    row = spans.get(name)
    if not row or not row["calls"]:
        return None
    seconds = row["host_s"]
    if less is not None:
        if less not in spans:
            return None
        seconds -= spans[less]["host_s"]
    return 1000.0 * seconds / row["calls"]


def stream_ms_per_clip(run, name: str, self_time: bool = False) -> Optional[float]:
    """Stream milliseconds per call of span ``name`` (less its children on
    the same stream with ``self_time``) over the cell's batch; None off a
    card or where the span never ran."""
    if torch.device(run.device).type != "cuda" or not run.cell:
        return None
    row = table().get(name)
    key = "stream_self_s" if self_time else "stream_s"
    if not row or not row["calls"] or row[key] is None:
        return None
    return 1000.0 * row[key] / row["calls"] / run.cell["batch"]


def count_per_call(counter: str, name: str) -> Optional[float]:
    """Counter ``counter`` over the calls of span ``name``; None where
    either is missing."""
    row = table().get(name)
    count = counters().get(counter)
    if not row or not row["calls"] or count is None:
        return None
    return count / row["calls"]
