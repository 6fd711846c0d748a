"""Two-process dry run of the batched render — port of the root
``tools/dryrun_distributed.py``.

The data-parallel batch axis is the natural cross-process axis: nothing in
the render communicates across clips.  Each of two processes joins one gloo
process group (``parallel.mesh.initialize_distributed``), renders its four
of the batch's eight rows over a local mesh of two shards
(``render_batch(device_mesh=...)``), and ``torch.distributed.all_gather``
brings every process's host result and metrics to process 0, which checks
the whole batch and prints the JAX tool's JSON keys.

Usage:
  python -m audio_raytracing_studio_tpu_torch.tools.dryrun_distributed            # card
  python -m audio_raytracing_studio_tpu_torch.tools.dryrun_distributed --device cpu
  ... --save out.npz   # process 0 also writes the gathered batch and metrics

Both processes may share one card (``--device cuda`` puts both local
meshes on ``cuda:0``): gloo moves host tensors only.  If the workers do not
finish within ``--timeout`` seconds both are killed and reaped — a worker
that died before the rendezvous would leave the other blocked in it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np

NUM_PROCESSES = 2
LOCAL_DEVICES = 2  # shards of each process's local mesh
BATCH = 8
RATE = 8000
METRIC_KEYS = ("lufs", "true_peak_dbfs", "rms_dbfs")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def params():
    from ..params import RenderParams

    return RenderParams(target_layout="5.1 (Standard)", room_size=40.0)


def clips(rows) -> np.ndarray:
    """The dry run's clips for batch rows ``rows`` (seed = row), (B, n) mono."""
    t = np.arange(RATE // 4) / RATE
    return np.stack([(0.3 * np.sin(2 * np.pi * (150.0 + 20 * i) * t)).astype(np.float32)
                     for i in rows])


def worker(process_id: int, port: int, device: str, save: str) -> int:
    import torch
    import torch.distributed as dist

    from ..parallel import mesh as meshlib
    from ..parallel import sharding
    from ..utils.runtime import ensure_device

    if device == "cpu":
        torch.set_num_threads(1)  # a render bit for bit alike in every process
    meshlib.initialize_distributed(f"127.0.0.1:{port}", NUM_PROCESSES, process_id)
    try:
        dev = ensure_device(device)
        local = meshlib.make_mesh(data=LOCAL_DEVICES, devices=[dev] * LOCAL_DEVICES)
        per_proc = BATCH // NUM_PROCESSES
        rows = list(range(process_id * per_proc, (process_id + 1) * per_proc))
        out, metrics = sharding.render_batch(clips(rows), RATE, params(), seeds=rows,
                                             device_mesh=local, with_metrics=True,
                                             device=device)
        table = np.asarray([[m[k] for k in METRIC_KEYS] for m in metrics], np.float64)
        if not (np.isfinite(out).all() and np.abs(out).max() > 1e-4
                and np.isfinite(table).all()):
            raise RuntimeError(f"process {process_id}: silent or non-finite render")
        gathered = []
        for local_part in (torch.from_numpy(out), torch.from_numpy(table)):
            parts = [torch.empty_like(local_part) for _ in range(NUM_PROCESSES)]
            dist.all_gather(parts, local_part)
            gathered.append(torch.cat(parts).numpy())
        full, full_metrics = gathered
        if process_id == 0:
            if full.shape[0] != BATCH:
                raise RuntimeError(f"gathered {full.shape[0]} rows of {BATCH}")
            if save:
                np.savez(save, out=full, metrics=full_metrics)
            from .bench_long import card

            print(json.dumps({
                "ok": True,
                "processes": NUM_PROCESSES,
                "global_devices": NUM_PROCESSES * LOCAL_DEVICES,
                "batch": BATCH,
                "out_shape": list(full.shape),
                "lufs": [round(float(v), 4) for v in full_metrics[:, 0]],
                "device": card(device),
            }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun_distributed", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--save", default="", help="process 0 writes the gathered batch here (.npz)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker, args.port, args.device, args.save)
    from .bench_long import needs_card

    error = needs_card(args.device)
    if error:
        print(json.dumps({"ok": False, "error": error}))
        return 1

    with socket.socket() as s:  # a free localhost port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "audio_raytracing_studio_tpu_torch.tools.dryrun_distributed",
           "--device", args.device, "--port", str(port)]
    if args.save:
        cmd += ["--save", os.path.abspath(args.save)]
    procs = [
        subprocess.Popen(cmd + ["--worker", str(i)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for i in range(NUM_PROCESSES)
    ]
    try:
        outs = [p.communicate(timeout=args.timeout) for p in procs]
    except subprocess.TimeoutExpired:
        # one worker dying before the rendezvous leaves the other blocked in
        # it forever: kill and reap both
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
        for i, (o, e) in enumerate(outs):
            sys.stderr.write(f"--- worker {i} timed out, killed (rc={procs[i].returncode}) ---\n"
                             f"{o}\n{e[-3000:]}\n")
        return 1
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for i, (o, e) in enumerate(outs):
            sys.stderr.write(f"--- worker {i} (rc={rcs[i]}) ---\n{o}\n{e[-3000:]}\n")
        return 1
    sys.stdout.write(outs[0][0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
