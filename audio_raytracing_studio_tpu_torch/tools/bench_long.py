"""Long renders on the card — port of ``tools/bench_long.py``: its ``long``
mode (one long clip through the streaming renderer) and its ``pallas`` mode,
here ``bank`` (a batch with a long IR, the CUDA bank against the plain IR
path).

    python -m audio_raytracing_studio_tpu_torch.tools.bench_long [long|bank|all] \\
        [--minutes 30] [--bass 1.0] [--treble 1.0] [--exact] [--batch 16] \\
        [--seconds 60] [--device cuda]

``long`` (the default) renders a ``--minutes`` mono clip at 48 kHz (5.1, room 200, seed 1, 30 s
chunks, metrics on) with ``parallel.streaming.render_streaming`` and prints
one JSON line with three realtime factors (audio seconds per wall second, the
host clock around each call):

- ``compute``: ``return_output=False`` — the render and the meter on the
  card, only the metrics come down;
- ``end_to_end``: the float32 result copied down as well;
- ``end_to_end_pcm16``: the result quantized to PCM16 on the card and
  copied down (half the bytes); ``pcm16_bit_identical`` says whether it
  equals quantizing the float32 result on the host.

``--exact`` runs the exact-length air filter (``fast_filters=False``).  One
untimed render at the full shape comes first (cuFFT plans, the bank's build,
page-locked buffers).

``bank`` renders ``--batch`` mono clips of ``--seconds`` through the
Cathedral hall at room size 600 (an IR of 346,809 samples at 48 kHz, whose
bank output overflows the card's 50 MB L2), Stereo, fast filters, with the
inputs already on the device: ``sharding._batched_internal`` (the device
part of ``render_batch``) with ``ir_backend="bank"`` (the CUDA kernels) and
with ``ir_backend="jnp"`` (the plain per-clip ``synthesize``), each warmed
once and then timed as the mean of 3 calls; the line carries both realtime
factors and the max-abs between the two renders.

Each line names the device (``card``).  Without a CUDA device, and without
``--device cpu``, it prints one JSON line with an ``"error"`` and exits 1: it
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np

RATE = 48000
LAYOUT = "5.1 (Standard)"
ROOM_SIZE = 200.0
SEED = 1
CHUNK_SECONDS = 30.0


def make_long_clip(minutes: float, rate: int = RATE) -> np.ndarray:
    """The benchmark's mono clip: a 220 Hz tone plus an 880 Hz tone under a
    3.1 Hz tremolo, float32."""
    n = int(minutes * 60.0 * rate)
    t = np.arange(n, dtype=np.float64) / rate
    return (0.25 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * np.sin(2 * np.pi * 3.1 * t) * np.sin(2 * np.pi * 880.0 * t)
            ).astype(np.float32)


def card(device="cuda") -> dict:
    """The device a tool's line was measured on: for a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them, else ``{"name": "cpu"}``."""
    import torch

    if torch.device(device).type != "cuda":
        return {"name": "cpu"}
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    name, _, limit = proc.stdout.strip().splitlines()[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def needs_card(device) -> Optional[str]:
    """Why a tool cannot run on ``device`` here, or None: the tools take
    ``--device`` (default ``cuda``) and never fall back to the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return ("needs a CUDA device (torch.cuda.is_available() is False); "
                "pass --device cpu for the plain PyTorch path")
    return None


def bench_long(clip: np.ndarray, bass: float = 1.0, treble: float = 1.0,
               exact: bool = False, device="cuda"):
    """Time the streaming render of ``clip`` → (figures, float32 output,
    metrics) on ``device``."""
    from ..config import OUTPUT_CLIP
    from ..parallel.streaming import render_streaming
    from ..params import RenderParams
    from ..utils import wavio

    seconds = clip.shape[0] / RATE
    p = RenderParams(target_layout=LAYOUT, room_size=ROOM_SIZE, bass_gain=bass,
                     treble_gain=treble)
    kwargs = dict(seed=SEED, chunk_seconds=CHUNK_SECONDS, with_metrics=True,
                  fast_filters=not exact, device=device)

    def timed(**extra):
        t0 = time.perf_counter()
        result = render_streaming(clip, RATE, p, **kwargs, **extra)
        return time.perf_counter() - t0, result

    timed(return_output=False)  # plans, the bank's build, buffers
    compute_s, (_, metrics) = timed(return_output=False)
    e2e_s, (out, _) = timed()
    e2e16_s, (out16, _) = timed(pcm16_output=True)
    host16 = wavio.encode_pcm16(np.clip(out, -OUTPUT_CLIP, OUTPUT_CLIP))
    figures = {
        "metric": "streaming_long_render_realtime_factor",
        "filters": "exact" if exact else "fast",
        "minutes": seconds / 60.0,
        "rate": RATE,
        "layout": LAYOUT,
        "bass_gain": bass,
        "treble_gain": treble,
        "compute": seconds / compute_s,
        "compute_wall_s": compute_s,
        "end_to_end": seconds / e2e_s,
        "end_to_end_wall_s": e2e_s,
        "end_to_end_pcm16": seconds / e2e16_s,
        "end_to_end_pcm16_wall_s": e2e16_s,
        "pcm16_bit_identical": bool(np.array_equal(out16, host16)),
        "out_shape": list(out.shape),
        "result_mb": out.nbytes / 1e6,
        "result_pcm16_mb": out16.nbytes / 1e6,
        "metrics": metrics,
    }
    return figures, out, metrics


def bench_bank(batch: int = 16, seconds: float = 60.0, iters: int = 3,
               device="cuda") -> dict:
    """Cathedral 600 × ``batch`` clips: the CUDA bank against the plain IR
    path, on device-resident inputs → the line's figures."""
    from ..params import RenderParams
    from ..utils.profiling import time_call
    from .profile_render import bench_inputs

    t = np.arange(int(seconds * RATE)) / RATE
    clips = np.stack([(0.3 * np.sin(2 * np.pi * (200.0 + 11.0 * i) * t)).astype(np.float32)
                      for i in range(batch)])
    p = RenderParams(hall_type="Cathedral", room_size=600.0, target_layout="Stereo")
    inputs = bench_inputs(clips, True, device, params=p)

    rtf, outs = {}, {}
    for backend in ("bank", "jnp"):
        timing = time_call(inputs.render, backend, name=backend, iterations=iters,
                           device=device)
        rtf[backend] = batch * seconds / timing.seconds_per_call
        outs[backend] = inputs.render(backend)
    return {
        "metric": "cathedral600_60s48k_compute_realtime_factor",
        "batch": batch,
        "clip_s": seconds,
        "ir_length": inputs.setup.ir_shape.length,
        "ir_backend_bank": rtf["bank"],
        "ir_backend_jnp": rtf["jnp"],
        "max_abs_bank_vs_jnp": float((outs["bank"] - outs["jnp"]).abs().max()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="long", choices=["long", "bank", "all"])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--bass", type=float, default=1.0)
    ap.add_argument("--treble", type=float, default=1.0)
    ap.add_argument("--exact", action="store_true",
                    help="fast_filters=False: the exact-length air filter")
    ap.add_argument("--batch", type=int, default=16, help="bank: clips in the batch")
    ap.add_argument("--seconds", type=float, default=60.0, help="bank: seconds per clip")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    error = needs_card(args.device)
    if error:
        print(json.dumps({"error": error}))
        return 1
    device = card(args.device)
    if args.which in ("long", "all"):
        figures, _, _ = bench_long(make_long_clip(args.minutes), args.bass, args.treble,
                                   args.exact, device=args.device)
        print(json.dumps({**figures, "device": device}), flush=True)
    if args.which in ("bank", "all"):
        figures = bench_bank(args.batch, args.seconds, device=args.device)
        print(json.dumps({**figures, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
