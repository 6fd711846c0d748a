"""Streaming render of one long clip on the card — port of the ``long`` mode of
``tools/bench_long.py``.

    python -m audio_raytracing_studio_tpu_torch.tools.bench_long [--minutes 30] \\
        [--bass 1.0] [--treble 1.0] [--exact]

Renders a ``--minutes`` mono clip at 48 kHz (5.1, room 200, seed 1, 30 s
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
page-locked buffers).  Without a CUDA device it prints an error and exits 1:
it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def card() -> dict:
    """The card's name and its power limit as nvidia-smi reports them."""
    import torch

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": proc.stdout.strip().splitlines()[0]}


def bench_long(clip: np.ndarray, bass: float = 1.0, treble: float = 1.0,
               exact: bool = False, device="cuda"):
    """Time the streaming render of ``clip`` → (figures, float32 output,
    metrics).  ``device`` must be a card."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--bass", type=float, default=1.0)
    ap.add_argument("--treble", type=float, default=1.0)
    ap.add_argument("--exact", action="store_true",
                    help="fast_filters=False: the exact-length air filter")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "needs a CUDA device (torch.cuda.is_available() is False)"}))
        return 1
    figures, _, _ = bench_long(make_long_clip(args.minutes), args.bass, args.treble, args.exact)
    figures["device"] = card()
    print(json.dumps(figures), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
