"""Stage breakdown of the batched internal-hall render on one GPU.

    python -m audio_raytracing_studio_tpu_torch.tools.profile_render [--batch 48] [--seconds 60]

On the ``bench.py`` configuration (Room hall, Stereo, EQ off, 48 kHz) it
times, for each filter mode, every stage of ``sharding._batched_internal``
alone with CUDA events on device-resident inputs — the IR bank, the conv
FFTs, the exact-length air filter, the back half (mix, normalizes, pan,
layout) — then the whole render, and runs one render under
``torch.profiler`` for the kernel time by name and the device's busy share.
Prints one JSON line per mode, each naming the card and its power limit.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

RATE = 48000


def bench_clips(batch: int, seconds: float) -> np.ndarray:
    """The bench.py clips: distinct tones plus deterministic noise per clip."""
    t = np.arange(int(seconds * RATE)) / RATE
    rng = np.random.default_rng(0xBE7C)
    return np.stack(
        [
            (
                0.3 * np.sin(2 * np.pi * (180.0 + 9.0 * i) * t)
                + 0.05 * np.sin(2 * np.pi * (1000.0 + 37.0 * i) * t)
            ).astype(np.float32)
            + (0.02 * rng.standard_normal(t.shape)).astype(np.float32)
            for i in range(batch)
        ]
    )


def event_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled(fn) -> dict:
    """One call under torch.profiler: kernel time by name and busy share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(kernels.values())  # one stream: kernels do not overlap
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "profiled_wall_ms": wall_ms,
        "kernel_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_kernels_ms": [[name[:100], ms] for name, ms in top],
    }


def stage_times(clips: np.ndarray, fast: bool) -> dict:
    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import convolution, filters, ir_synth
    from audio_raytracing_studio_tpu_torch.ops.ir_synth_cuda import fused_rir_bank
    from audio_raytracing_studio_tpu_torch.parallel import sharding

    batch, n_in = clips.shape
    audio = torch.from_numpy(
        np.stack([pipeline._ensure_stereo_host(c).T for c in clips])
    ).cuda()
    seeds = torch.arange(batch, dtype=torch.int32, device="cuda")
    setup = pipeline.build_internal_setup(
        RenderParams(target_layout="Stereo"), RATE, n_in, fast_filters=fast
    )
    spec, shape = setup.spec, setup.ir_shape
    ir_sc = ir_synth.IRScalars.stack([setup.ir_scalars] * batch)
    mix = pipeline.MixScalars.stack([setup.mix_scalars] * batch, "cuda")
    len_out = spec.len_out

    early, late = fused_rir_bank(seeds, shape, ir_sc)
    kernels = torch.stack([early, late], dim=1)
    weights = torch.stack([mix.early_level, mix.late_level], dim=1)
    stages = {"bank": event_ms(lambda: fused_rir_bank(seeds, shape, ir_sc))}
    if fast:
        nfft = convolution.fast_fft_length(max(len_out, n_in + shape.length - 1))
        air = filters.air_absorption_gain(nfft, RATE, mix.air_absorption)
        gains = torch.stack([torch.ones_like(air), air], dim=1)
        stages["air_gain"] = event_ms(
            lambda: filters.air_absorption_gain(nfft, RATE, mix.air_absorption)
        )
        stages["conv_combined"] = event_ms(
            lambda: convolution.convolve_combined(audio, kernels, weights, len_out, gains)
        )
        wet = convolution.convolve_combined(audio, kernels, weights, len_out, gains)
        del air, gains
    else:
        conv = convolution.convolve_full(audio, kernels, len_out)
        stages["conv_full"] = event_ms(
            lambda: convolution.convolve_full(audio, kernels, len_out)
        )
        late_wet = conv[:, 1]
        stages["exact_air"] = event_ms(
            lambda: filters.apply_air_absorption(late_wet, RATE, mix.air_absorption)
        )
        late_wet = filters.apply_air_absorption(late_wet, RATE, mix.air_absorption)
        wet = conv[:, 0] * mix.early_level[:, None, None] + late_wet * mix.late_level[:, None, None]
        del conv, late_wet
    dry = torch.nn.functional.pad(audio, (0, len_out - n_in))
    stages["back_half"] = event_ms(lambda: pipeline._mix_eq_spatial(dry, wet, mix, spec))
    del dry, wet

    def render():
        return sharding._batched_internal(audio, seeds, ir_sc, mix, shape, spec)

    stages["whole"] = event_ms(render)
    return {"stages_ms": stages, **profiled(render)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=60.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    clips = bench_clips(args.batch, args.seconds)
    for fast in (True, False):
        row = {"card": card, "mode": "fast" if fast else "exact",
               "batch": args.batch, "clip_s": args.seconds}
        row.update(stage_times(clips, fast))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
