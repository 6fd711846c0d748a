"""What every cell shares: the run's record, the traced window, device
timing, the correctness check against the plain reference, and the result
line."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .reference import render as ref

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_raytracing_studio_tpu")
HOST_SPAN = "portbench."  # prefix of the harness's own host spans


@dataclasses.dataclass
class Sample:
    """One answer the timed path produced, with what the reference needs to
    work it out again from the same inputs."""

    key: tuple  # the same key → the same inputs → one reference render
    pcm: np.ndarray  # the program's (len, C) int16
    metrics: Optional[dict]
    clip: np.ndarray  # the input as handed to the program
    params: dict
    seed: int
    clip_length: Optional[int]
    fast: bool
    padded_eq: bool


class Run:
    """One run of one cell: its settings, and what the generator and the
    readers record."""

    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_start = time.perf_counter()
        self.setup_split: Dict[str, float] = {}
        self._t_mark = self.t_start
        self.setup_s: Optional[float] = None
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, float] = {}
        self.cell: dict = {}  # the cell's shapes, for the kernel readers
        self.samples: List[Sample] = []
        self.attempted = 0
        self.failed = 0
        self.end_to_end: Dict[str, float] = {}
        self.trace_summary: Optional[dict] = None
        self.memory_peak_bytes = 0

    # --- set-up ---
    def mark(self, stage: str) -> None:
        """Close a set-up stage: its seconds since the previous mark."""
        now = time.perf_counter()
        self.setup_split[stage] = now - self._t_mark
        self._t_mark = now

    def setup_done(self) -> None:
        self.sync()
        self.mark("warm_up")
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the harness around a call into the program."""
        with torch.profiler.record_function(HOST_SPAN + name):
            t0 = time.perf_counter()
            yield
            self.spans[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def window(self):
        """The measured window; under the profiler when the run is traced."""
        if not self.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(HOST_SPAN + "window"):
                yield
            self.sync()
        self.trace_summary = summarize(prof)

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def trace_device(self, fn: Callable[[], object], iters: int) -> Optional[float]:
        """Device seconds per call of ``fn`` alone: the union of its kernels'
        intervals in a profiler trace of ``iters`` calls, after one warm-up
        call, over ``iters``; None when the trace saw no kernel."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(HOST_SPAN + "window"):
                for _ in range(iters):
                    fn()
                self.sync()
        summary = summarize(prof)
        if not summary or summary["kernel_s"] <= 0:
            return None
        return summary["kernel_s"] / iters


# --- the trace ---------------------------------------------------------------
def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> dict:
    """Device busy time, kernel time, each kernel name's time and launches,
    the top device operations and the longest idle gaps (named by the
    harness span the host was in) inside the traced window."""
    events = prof.events()
    cuda_type = torch.autograd.DeviceType.CUDA
    window = None
    host, device = [], []
    for e in events:
        tr = e.time_range
        # a host span also shows on the device's timeline as an annotation
        # over the work it enqueued: not device work
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(HOST_SPAN)
        if e.device_type == cuda_type:
            if not annotation:
                device.append((tr.start, tr.end, e.name))
        elif e.name.startswith(HOST_SPAN):
            if e.name == HOST_SPAN + "window":
                window = (tr.start, tr.end)
            else:
                host.append((tr.start, tr.end, e.name[len(HOST_SPAN):]))
    if window is None:
        return {}
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in device])
    kernels = _union([(s, e) for s, e, n in device
                      if not n.startswith(("Memcpy", "Memset"))])
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for s, e, n in device:
        by_name[n] += (e - s) / 1e6
        launches[n] += 1
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            label = next((n for hs, he, n in host if hs <= mid <= he), "host")
            gaps.append([label, (e - s) / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "kernel_s": sum(e - s for s, e in kernels) / 1e6,
        "by_name": {n: (t, launches[n]) for n, t in by_name.items()},
        "device_ops": sorted(([n[:80], t] for n, t in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
    }


# --- correctness ---------------------------------------------------------------
def _gap(a: float, b: float) -> float:
    if math.isinf(a) or math.isinf(b):
        return 0.0 if a == b else math.inf
    return abs(a - b)


def compare(sample: Sample, out: torch.Tensor, ref_metrics: dict) -> Dict[str, float]:
    """The numbers compared for one answer: the widest gap of its 16-bit
    samples from the reference's (before rounding, in LSB), and the gaps of
    its LUFS, sample peak and RMS."""
    want = ref.pcm16_scaled(out)
    if sample.pcm.shape != want.shape:
        return {"pcm_gap_lsb": math.inf, "lufs_gap_lu": math.inf,
                "peak_gap_db": math.inf, "rms_gap_db": math.inf}
    numbers = {"pcm_gap_lsb": float(np.abs(sample.pcm.astype(np.float64) - want).max())}
    if sample.metrics is not None:
        numbers["lufs_gap_lu"] = _gap(sample.metrics["lufs"], ref_metrics["lufs"])
        numbers["peak_gap_db"] = _gap(sample.metrics["true_peak_dbfs"], ref_metrics["true_peak_dbfs"])
        numbers["rms_gap_db"] = _gap(sample.metrics["rms_dbfs"], ref_metrics["rms_dbfs"])
    return numbers


def check(run: Run, limits: Dict[str, float], prec: ref.Precision = ref.FLOAT64):
    """Work every sampled answer out again with the plain reference (on the
    run's device, after the window) → (correct, {name: (value, limit)})."""
    worst: Dict[str, float] = {name: 0.0 for name in limits}
    done: Dict[tuple, tuple] = {}
    rate = int(run.config["rate"])
    with ref.few_fft_plans(run.device):
        for s in run.samples:
            if s.key not in done:
                out, valid = ref.render_row(s.clip, rate, s.params, s.seed, s.clip_length,
                                            s.fast, s.padded_eq, prec, run.device)
                done[s.key] = (out, ref.meter(out, valid, rate, prec))
            for name, value in compare(s, *done[s.key]).items():
                worst[name] = max(worst.get(name, 0.0), value)
    table = {name: (worst[name], limits[name]) for name in limits}
    correct = bool(run.samples) and all(v <= lim for v, lim in table.values())
    return correct, table


def offending_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that this process must not hold
    (compared whole: the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def finite(x: float) -> float:
    """JSON has no infinity: an answer that never came reads 1e9."""
    return x if math.isfinite(x) else 1e9


def device_info(run: Run) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = run.memory_peak_bytes
    if run.trace and run.trace_summary:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info


def result_line(run: Run, correct: bool, table: dict, metrics: dict) -> dict:
    line = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(run),
    }
    if run.trace and run.trace_summary:
        line["breakdown"] = {k: run.trace_summary[k] for k in ("device_ops", "idle_gaps")}
    for m in metrics.values():
        m["value"] = finite(m["value"])
    line["check"] = {name: {"value": finite(v), "limit": lim} for name, (v, lim) in table.items()}
    return line


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
