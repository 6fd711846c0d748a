"""Headline benchmark of the port: batched realtime factor on one card — port
of the root ``bench.py``.

    python -m audio_raytracing_studio_tpu_torch.tools.bench [--batch 48] [--seconds 60] \\
        [--device cuda]

The workload is ``bench.py``'s: B=48 mono clips × 60 s at 48 kHz (the
``0xBE7C`` generator of ``tools.profile_render.bench_clips``: distinct tones
plus noise per clip), Room hall, default material, Stereo, EQ off, seeds
0 .. B-1, every input already on the device.  The timed call is
``sharding._batched_internal`` (the device part of ``render_batch``: the
CUDA bank, the convolution, air, mix, pan and layout, no meter), in the
fast filter mode and then the exact one.

The protocol (``settle_and_median``): one warm-up call; then calls until two
consecutive samples agree within 20%, at most ``BENCH_SETTLE_MAX`` (12); then
the median of ``BENCH_ITERS`` (3) calls.  Each sample is the host clock around
a call that ends in ``torch.cuda.synchronize``.  The JAX tool falls through
silently when the settle loop runs out; here ``settled_fast`` /
``settled_exact`` say whether two samples agreed, and ``settle_s_*`` how long
settling took.

Prints ONE JSON line: ``metric``, ``value`` (fast), ``unit``,
``vs_baseline``, ``value_exact``, ``vs_baseline_exact``, the settle fields,
the batch and clip length, and ``device`` (the card's name and power limit).
``vs_baseline`` divides by the realtime factor in the repository's
``BASELINE_CPU.json``: the float64 NumPy/SciPy oracle rendering one such clip
single-threaded on a CPU (``tools/measure_cpu_baseline.py``), null when the
file is absent.  ``BENCH_BATCH`` sets the default batch; ``BENCH_FAST=0`` or
``BENCH_EXACT=0`` skips a mode (exact is then the headline ``value``).

Without a CUDA device, and without ``--device cpu``, it prints the line with
an ``"error"`` and exits 1: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional

METRIC = "realtime_factor_60s48k_batched_per_chip"
UNIT = "audio_seconds_per_second"
SETTLE_TOL = 0.2  # two consecutive samples within 20% of the smaller one
BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "BASELINE_CPU.json",
)


def settle_and_median(run: Callable[[], object], sync: Callable[[], object],
                      settle_max: int = 12, samples: int = 3,
                      clock: Callable[[], float] = time.perf_counter) -> dict:
    """``bench.py``'s timing protocol for ``run``.

    One warm-up call, then calls until two consecutive samples agree within
    ``SETTLE_TOL``, at most ``settle_max``, then ``samples`` timed calls.  A
    sample is ``clock`` around ``run(); sync()``.  Returns ``wall_s`` (the
    median), ``runs_s`` (the timed samples, sorted), ``settle_runs_s``,
    ``settled`` (False when the loop ran out without two samples agreeing)
    and ``settle_s`` (the time spent settling).
    """

    def once() -> float:
        t0 = clock()
        run()
        sync()
        return clock() - t0

    once()  # warm-up: cuFFT plans, the allocator, the kernels' first build
    settle: list = []
    settled = False
    for _ in range(settle_max):
        settle.append(once())
        if len(settle) >= 2 and abs(settle[-1] - settle[-2]) <= SETTLE_TOL * min(settle[-2:]):
            settled = True
            break
    runs = sorted(once() for _ in range(samples))
    return {"wall_s": runs[len(runs) // 2], "runs_s": runs, "settle_runs_s": settle,
            "settled": settled, "settle_s": sum(settle)}


def baseline_rtf() -> Optional[float]:
    """The CPU oracle's realtime factor from ``BASELINE_CPU.json``, or None."""
    try:
        with open(BASELINE_PATH) as f:
            return float(json.load(f)["realtime_factor"])
    except (OSError, ValueError, KeyError):
        return None


def workload(batch: int, seconds: float, fast: bool, device="cuda") -> Callable:
    """The timed computation: a zero-argument call of
    ``sharding._batched_internal`` on the bench batch, already on ``device``
    → (B, 2, len_out) float32."""
    from .profile_render import bench_clips, bench_inputs

    return bench_inputs(bench_clips(batch, seconds), fast, device).render


def measure(batch: int, seconds: float, fast: bool, device="cuda", settle_max: int = 12,
            iters: int = 3) -> dict:
    """Warm up, settle and time one filter mode → the protocol's dict plus
    ``rtf`` (audio seconds per wall second)."""
    import torch

    run = workload(batch, seconds, fast, device)
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    result = settle_and_median(run, sync, settle_max, iters)
    result["rtf"] = batch * seconds / result["wall_s"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=int(os.environ.get("BENCH_BATCH", "48")))
    ap.add_argument("--seconds", type=float, default=60.0, help="seconds per clip")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    from .bench_long import card, needs_card

    record = {"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0}
    error = needs_card(args.device)
    if error:
        print(json.dumps({**record, "error": error}))
        return 1

    iters = int(os.environ.get("BENCH_ITERS", "3"))
    settle_max = int(os.environ.get("BENCH_SETTLE_MAX", "12"))
    baseline = baseline_rtf()

    def ratio(rtf):
        return None if baseline is None else rtf / baseline

    record.update(batch=args.batch, clip_s=args.seconds, iters=iters)
    modes = [("fast", True)] if os.environ.get("BENCH_FAST", "1") == "1" else []
    if os.environ.get("BENCH_EXACT", "1") == "1":
        modes.append(("exact", False))
    for name, fast in modes:
        result = measure(args.batch, args.seconds, fast, args.device, settle_max, iters)
        suffix = "" if fast else "_exact"
        record[f"value{suffix}"] = result["rtf"]
        record[f"vs_baseline{suffix}"] = ratio(result["rtf"])
        record[f"settled_{name}"] = result["settled"]
        record[f"settle_s_{name}"] = result["settle_s"]
        record[f"settle_runs_{name}_s"] = result["settle_runs_s"]
        record[f"runs_{name}_s"] = result["runs_s"]
        if not result["settled"]:
            print(f"bench: the {name} settle loop ran out after {settle_max} samples "
                  f"without two agreeing within {SETTLE_TOL:.0%}", file=sys.stderr)
    if "value_exact" in record and "settled_fast" not in record:
        record["value"] = record["value_exact"]  # the fast arm skipped: exact is the headline
        record["vs_baseline"] = record["vs_baseline_exact"]
    record["device"] = card(args.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
