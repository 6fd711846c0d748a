"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Drives the port's main path — the batched internal-hall render that
``bench.py`` times for the JAX package (B=48 mono clips, 60 s at 48 kHz,
Room hall, Stereo layout, EQ off, fast and exact filter modes) — through
``render_batch``, and checks it.  Phases, one line each:

1. environment: torch/CUDA versions, card name and power limit, TF32 off;
2. build: compiles ``csrc/rir_bank.cu`` with nvcc from this checkout;
3. bank check: the CUDA RIR-bank kernel against its plain PyTorch version
   on the card (bench shape with seeds ≥ 2^31; a multi-tile Cathedral IR);
4. main path: fast and exact renders at full size, one kernel launch each,
   output checks, clips 0 and 47 against the port's plain path on the CPU,
   and one PCM16 render;
5. timing: realtime factor of both modes on device-resident inputs (settle,
   then the median of 3), and the bank kernel's time beside the plain
   version's (CUDA events).

Then one JSON line per kernel, the card's name and power limit, and the
last line ``{"ok": true, "device": {...}}``.  Any failure raises: the exit
code is non-zero and no result line is printed.  Without a CUDA device, or
without the rest of the checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BATCH = 48
DURATION_S = 60.0
RATE = 48000
BANK_TOL = 2e-5  # kernel vs plain bank on the card: float round-off (sum order, expf/powf ulps)
RENDER_TOL = 1e-4  # card vs CPU render: cuFFT vs pocketFFT float32 over 3·2^20 and 2,951,999 points


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def settled_wall(torch, fn, settle_max: int = 12, samples: int = 3):
    """bench.py's protocol: run until two consecutive samples agree within
    20%, then the median of ``samples`` timed runs (host clock + sync)."""

    def once():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    once()  # warm-up: cuFFT plans, allocator
    settle = []
    for _ in range(settle_max):
        settle.append(once())
        if len(settle) >= 2 and abs(settle[-1] - settle[-2]) <= 0.2 * min(settle[-2:]):
            break
    runs = sorted(once() for _ in range(samples))
    return runs[len(runs) // 2], settle, runs


def main() -> int:
    import torch

    # --- 1. environment ---
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import ir_synth
    from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips
    from audio_raytracing_studio_tpu_torch.utils import kernels

    # the path runs no matmul and no cuDNN convolution; pin both off anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 still on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 still on")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} card {card!r} nvidia-smi {smi!r} tf32 off",
          flush=True)

    # --- 2. build ---
    t0 = time.perf_counter()
    lib = kernels.build("rir_bank")
    print(f"[2 build] {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # --- 3. bank check: kernel vs plain on the card ---
    p = RenderParams(target_layout="Stereo")
    n_in = int(DURATION_S * RATE)
    bench_setup = pipeline.build_internal_setup(p, RATE, n_in)
    cathedral = pipeline.build_internal_setup(
        RenderParams(hall_type="Cathedral", room_size=600.0), RATE, n_in
    )
    bank_err = 0.0
    for label, setup, seeds in (
        ("bench", bench_setup, list(range(BATCH)) + [2**31, 0xFFFFFFFF]),
        ("cathedral", cathedral, [0, 7, 2**31, 0xFFFFFFFF]),
    ):
        shape = setup.ir_shape
        seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).cuda()
        scal = setup.ir_scalars.table(len(seeds), "cuda")
        before = bank.launch_count
        kern = bank._finalize_bank(*bank._rir_block_cuda(seeds_t, scal, shape), shape)
        plain = bank._finalize_bank(*bank._rir_block_plain(seeds_t, scal, shape), shape)
        torch.cuda.synchronize()
        check(bank.launch_count == before + 1, "bank kernel launch was not counted")
        errs = [(k - q).abs().max().item() for k, q in zip(kern, plain)]
        check(all(np.isfinite(errs)) and max(errs) <= BANK_TOL,
              f"{label} bank kernel vs plain {errs} > {BANK_TOL}")
        bank_err = max(bank_err, *errs)
        print(f"[3 bank] {label}: B={len(seeds)} length={shape.length} tiles="
              f"{bank.n_tiles(shape)} max-abs early {errs[0]:.3e} late {errs[1]:.3e} "
              f"(tol {BANK_TOL})", flush=True)

    # --- 4. main path through render_batch ---
    clips = bench_clips(BATCH, DURATION_S)
    len_out = bench_setup.spec.len_out
    outputs = {}
    bank.launch_count = 0
    for fast in (True, False):
        before = bank.launch_count
        t0 = time.perf_counter()
        out = sharding.render_batch(clips, RATE, p, fast_filters=fast, device="cuda")
        wall = time.perf_counter() - t0
        check(bank.launch_count == before + 1, "render_batch did not launch the bank once")
        outputs[fast] = out
        mode = "fast" if fast else "exact"
        check(out.shape == (BATCH, len_out, 2), f"{mode} output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{mode} output has non-finite values")
        peak = float(np.abs(out).max())
        check(peak <= 1.0, f"{mode} peak {peak} > 1")
        tail = np.abs(out[:, n_in:]).max(axis=(1, 2))
        check(bool((tail > 0).all()), f"{mode}: a clip has a silent reverb tail")
        print(f"[4 main] {mode}: render_batch {out.shape} {out.dtype} in {wall:.2f} s "
              f"(host copies included) peak {peak:.4f} min tail peak {tail.min():.3e}",
              flush=True)
    main_launches = bank.launch_count

    for fast in (True, False):
        ref = sharding.render_batch(
            clips[[0, BATCH - 1]], RATE, p, seeds=[0, BATCH - 1],
            fast_filters=fast, device="cpu",
        )
        err = float(np.abs(outputs[fast][[0, BATCH - 1]] - ref).max())
        mode = "fast" if fast else "exact"
        check(err <= RENDER_TOL, f"{mode} card vs CPU {err} > {RENDER_TOL}")
        print(f"[4 main] {mode}: clips 0 and {BATCH - 1} card vs CPU plain path "
              f"max-abs {err:.3e} (tol {RENDER_TOL})", flush=True)
    q = sharding.render_batch(clips[:4], RATE, p, seeds=range(4), pcm16_output=True,
                              device="cuda")
    check(q.dtype == np.int16 and q.shape == (4, len_out, 2), f"pcm16 output {q.dtype} {q.shape}")
    want = np.rint(np.clip(outputs[True][:4], -0.9999, 0.9999) * 32768.0)
    lsb = int(np.abs(q.astype(np.int32) - want.astype(np.int32)).max())
    check(lsb <= 1, f"pcm16 differs from the float render by {lsb} LSB")
    print(f"[4 main] pcm16: {q.dtype} {q.shape}, within {lsb} LSB of the float render",
          flush=True)
    del outputs, q

    # --- 5. timing on device-resident inputs ---
    audio_t = torch.from_numpy(
        np.stack([pipeline._ensure_stereo_host(c).T for c in clips])
    ).cuda()
    seeds_t = torch.arange(BATCH, dtype=torch.int32, device="cuda")
    timing = {"card": card, "nvidia_smi": smi, "batch": BATCH, "clip_s": DURATION_S}
    for fast in (True, False):
        setup = pipeline.build_internal_setup(p, RATE, n_in, fast_filters=fast)
        ir_sc = ir_synth.IRScalars.stack([setup.ir_scalars] * BATCH)
        mix = pipeline.MixScalars.stack([setup.mix_scalars] * BATCH, "cuda")
        torch.cuda.reset_peak_memory_stats()
        wall, settle, runs = settled_wall(
            torch,
            lambda: sharding._batched_internal(
                audio_t, seeds_t, ir_sc, mix, setup.ir_shape, setup.spec
            ),
        )
        mode = "fast" if fast else "exact"
        timing[f"rtf_{mode}"] = BATCH * DURATION_S / wall
        timing[f"wall_{mode}_s"] = wall
        timing[f"runs_{mode}_s"] = runs
        timing[f"settle_{mode}_s"] = settle
        timing[f"peak_mem_{mode}_gb"] = torch.cuda.max_memory_allocated() / 1e9
    scal = bench_setup.ir_scalars.table(BATCH, "cuda")
    shape = bench_setup.ir_shape
    kernel_fn = lambda: bank._rir_block_cuda(seeds_t, scal, shape)  # noqa: E731
    plain_fn = lambda: bank._rir_block_plain(seeds_t, scal, shape)  # noqa: E731
    for fn in (kernel_fn, plain_fn):  # warm-up
        fn()
    torch.cuda.synchronize()
    plain_a = cuda_ms(torch, plain_fn, 10)
    kernel_a = cuda_ms(torch, kernel_fn, 50)
    kernel_b = cuda_ms(torch, kernel_fn, 50)
    plain_b = cuda_ms(torch, plain_fn, 10)
    timing["bank_kernel_ms"] = (kernel_a + kernel_b) / 2
    timing["bank_plain_ms"] = (plain_a + plain_b) / 2
    timing["bank_runs_ms"] = {"plain": [plain_a, plain_b], "kernel": [kernel_a, kernel_b]}
    print("[5 timing] " + json.dumps(timing), flush=True)

    check("jax" not in sys.modules, "jax was imported")
    for name in ("ops", "models", "parallel"):
        check(f"audio_raytracing_studio_tpu.{name}" not in sys.modules,
              f"the JAX package's {name} was imported")

    print(json.dumps({"kernels": [{
        "name": "rir_bank",
        "route": "cuda",
        "source": "audio_raytracing_studio_tpu_torch/csrc/rir_bank.cu",
        "replaces": "audio_raytracing_studio_tpu/ops/ir_synth_pallas.py:121",
        "launches": main_launches,
        "max_abs_err": bank_err,
        "ms": timing["bank_kernel_ms"],
        "plain_ms": timing["bank_plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
