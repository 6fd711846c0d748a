"""Serving-layer bench: concurrent jobs through the port's ``RenderService`` —
port of ``tools/bench_serving.py``.

Measures what a client of the service sees — end-to-end job latency
including queueing, micro-batching, the batched render on the card, the
copy down and per-job trimming — and how well the batcher coalesced the
load.  Results are host arrays (int16: the service quantizes on the
device), so nothing is timed before the work is done.  Every result is
checked: its length is the job's true span (clip + IR − 1) and it is not
silent; a job that fails that check, or raises, counts in ``failed``.

Modes (each prints one JSON line; ``--matrix`` one per arm and a summary):

- burst (default): ``--jobs`` × ``--seconds`` jobs with a value sweep
  (diffusion, x position) into ``RenderService(pcm16_output=True)``;
  ``warm()`` first, then one warm-up burst, then the measured burst.
- ``--soak S``: Poisson arrivals (``--arrival-rate``) for S seconds of
  mixed-length (``--soak-durations``), mixed-metrics, mixed-EQ jobs, every
  ``--extir-every``-th through a shared external IR, after one serialized
  warm-up job per signature and ``warm()`` of the ``--warm-buckets``
  sizes: p50/p95/p99 latency, the histogram of dispatch sizes, rejections
  (backpressure), RSS at start/peak/end, the page-locked MB and the cuFFT
  plans from ``stats()``.
- ``--matrix --soak S``: the soak per arm of the service configuration:
  ``bank+extir`` (the CUDA bank, external-IR jobs in the mix), ``jnp``
  (``ir_backend="jnp"``, the plain IR path), and over a data mesh of
  ``--mesh-devices`` shards ``mesh`` (the plain IR path) and ``bank-mesh``
  (the bank once per shard).  The mesh takes the visible devices of
  ``--device``'s type in turn, so ``--mesh-devices 4`` on one card is
  ``[cuda:0] * 4``; with fewer than two shards the mesh arms are listed as
  skipped, as the JAX tool skips them on one device.
- ``--http --soak S``: every job runs the client's whole lifecycle over
  real HTTP against ``RenderHTTPService`` on 127.0.0.1 (upload, job POST,
  status polls, result download).  Uploads and results cycle through
  ``--http-formats`` (default WAV, FLAC and Ogg/Vorbis) on independent
  indices (``http_mix``): every clip length meets every upload codec, and
  every upload codec every result format; the line names them in ``formats``
  and ``mix``.  Each job's wall is split as the client sees it (upload, job
  POST with the upload's decode, queue and render, result GET with its
  encode), and the slowest jobs are listed with their split.

A ``StallWatchdog`` (``utils.watchdog``) guards every mode: when neither the
batcher's counters nor the process's I/O move for ``--stall-timeout``
seconds it prints the mode's line with an ``"error"`` and exits 3.

Usage:
  python -m audio_raytracing_studio_tpu_torch.tools.bench_serving          # 48 × 60 s
  python -m audio_raytracing_studio_tpu_torch.tools.bench_serving --soak 600 --arrival-rate 2
  python -m audio_raytracing_studio_tpu_torch.tools.bench_serving --jobs 4 --seconds 0.5 \\
      --rate 16000 --device cpu

Without a CUDA device, and without ``--device cpu``, it prints one JSON line
with an ``"error"`` and exits 1.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

BURST_METRIC = "serving realtime factor (audio-sec/sec, end-to-end jobs)"
SOAK_METRIC = "serving soak (Poisson arrivals, mixed lengths/metrics)"
HTTP_METRIC = "serving soak over HTTP (the line's formats, full job lifecycle)"
MESH_SKIPPED = "fewer than 2 mesh shards (--mesh-devices)"
HTTP_FORMATS = ["wav", "flac", "ogg"]  # uploads and results
HTTP_SPLIT = ("upload_s", "submit_s", "wait_s", "result_s")


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _slope_mb_per_min(samples, period_s: float = 5.0) -> float:
    """Least-squares slope of the last half of the RSS samples, MB per minute."""
    tail = samples[len(samples) // 2:]
    if len(tail) < 3:
        return 0.0
    x = np.arange(len(tail)) * (period_s / 60.0)
    return float(np.polyfit(x, np.asarray(tail, np.float64), 1)[0])


def _watchdog(svc, args, metric: str):
    """No-progress abort (``utils.watchdog``): progress is the batcher's own
    counters, and process-I/O movement on top, so a long transfer in flight
    never trips it.  A first call that builds kernels or plans at a new shape
    can sit quiet longer than the default: raise ``--stall-timeout`` (or 0
    to disable) then."""
    from ..utils.watchdog import StallWatchdog

    def progress():
        st = svc.stats()
        return (st["jobs_done"], st["jobs_failed"], st["batches"])

    return StallWatchdog(
        progress,
        timeout_s=args.stall_timeout,
        stall_json={"metric": metric},
        name="bench-serving-watchdog",
    )


def expected_length(n: int, rate: int, params, ir_length: Optional[int] = None) -> int:
    """A job's true output span: clip + IR − 1 (the external IR's length, at
    the clip's rate, when ``params.use_external_ir``)."""
    from ..models import pipeline

    if params.use_external_ir:
        return n + ir_length - 1
    spec, _ = pipeline.build_internal_spec(params, rate, n)
    return spec.len_out


def result_fault(audio: np.ndarray, want: int) -> Optional[str]:
    """Why a result is wrong (length, silence), or None."""
    if audio.shape[0] != want:
        return f"length {audio.shape[0]} != {want}"
    if not np.any(audio):
        return "silent"
    return None


def _service(args, **overrides):
    from ..serving import RenderService

    kwargs = dict(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        fast_filters=args.fast_filters,
        pcm16_output=True,
        max_queued=args.max_queued,
        pipeline_depth=args.pipeline_depth,
        device=args.device,
    )
    kwargs.update(overrides)
    return RenderService(**kwargs)


def _soak_params(i: int, eq: bool, extir: bool) -> dict:
    """The soak's value sweep for job ``i``: EQ and the external IR flip per job."""
    p = {
        "target_layout": "Stereo",
        "diffusion": 0.2 + 0.6 * ((i * 37) % 100) / 100.0,
        "x_pos": 0.1 + 0.8 * ((i * 53) % 100) / 100.0,
        "bass_gain": 1.5 if eq else 1.0,
    }
    if extir:
        p["use_external_ir"] = True
    return p


def soak(args) -> int:
    """Poisson-arrival sustained-load soak through RenderService."""
    out = run_soak(args, extir_every=args.extir_every)
    print(json.dumps(out))
    return 1 if out["failed"] else 0


def mesh_devices(device: str, count: int) -> list:
    """``count`` devices of ``device``'s type, the visible ones taken in turn
    (one card stands in for several)."""
    import torch

    kind = torch.device(device).type
    visible = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if kind == "cuda" else [torch.device("cpu")])
    return [visible[i % len(visible)] for i in range(count)]


def matrix(args) -> int:
    """Soak-matrix mode: --soak seconds per arm of the service configuration,
    one JSON line per arm plus a summary."""
    arms = [("bank+extir", {}, args.extir_every or 5), ("jnp", {"ir_backend": "jnp"}, 0)]
    if args.mesh_devices >= 2:
        from ..parallel import mesh as meshlib

        m = meshlib.make_mesh(data=args.mesh_devices,
                              devices=mesh_devices(args.device, args.mesh_devices))
        arms.append(("mesh", {"device_mesh": m, "ir_backend": "jnp"}, 0))
        arms.append(("bank-mesh", {"device_mesh": m}, 0))
    rc = 0
    summary = []
    for label, kw, extir in arms:
        print(f"--- arm: {label} ---", file=sys.stderr)
        out = run_soak(args, svc_kwargs=kw, label=label, extir_every=extir)
        out["arm"] = label
        print(json.dumps(out), flush=True)
        rc |= 1 if out["failed"] else 0
        summary.append({
            "arm": label,
            "completed": out["completed"],
            "failed": out["failed"],
            "x_realtime": out["throughput_x_realtime"],
            "p95_s": out["latency_p95_s"],
            "rss_end_mb": out["rss_end_mb"],
        })
    if args.mesh_devices < 2:
        for label in ("mesh", "bank-mesh"):
            print(f"--- arm: {label}: skipped: {MESH_SKIPPED} ---", file=sys.stderr)
            summary.append({"arm": label, "skipped": MESH_SKIPPED})
    from .bench_long import card

    print(json.dumps({"metric": "serving soak matrix", "arms": summary,
                      "failed": sum(a.get("failed", 0) for a in summary),
                      "device": card(args.device)}))
    return rc


def http_mix(i: int, durations: list, codecs: list) -> tuple:
    """Job ``i``'s (clip duration, upload codec, result format): the duration
    cycles fastest, then the upload codec, then the result format, so no
    codec is tied to one clip length and every D × C × C jobs hold each
    combination once."""
    nd, nc = len(durations), len(codecs)
    return durations[i % nd], codecs[(i // nd) % nc], codecs[(i // (nd * nc)) % nc]


def _split_stats(values: list) -> dict:
    v = sorted(values)
    return {"p50": _pct(v, 0.50), "p95": _pct(v, 0.95), "max": v[-1] if v else 0.0}


def http_soak(args) -> int:
    """Sustained load THROUGH the HTTP layer: Poisson arrivals where each job
    is a full client lifecycle over real HTTP on this host — POST /v1/upload
    with WAV, FLAC or Ogg bytes (decoded on the request thread at job-POST
    time: the decode-starvation surface), POST /v1/jobs (mixed metrics, EQ
    and external-IR jobs, mixed result formats), polls of the status, the
    result's download (encoded on the request thread) and decode — and the
    upload and result files are counted to show they are reclaimed.  Each
    completed job's wall is split into upload, job POST, wait (queue, render
    and the 0.25 s poll) and result GET."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from http.client import HTTPConnection

    from ..params import RenderParams
    from ..serving import RenderJob
    from ..serving.service import RenderHTTPService
    from ..utils import wavio
    from .bench_long import card

    rate = args.rate
    rng = np.random.default_rng(0x177E)
    durations = [float(d) for d in args.soak_durations.split(",")]

    # one encoded upload per (duration, codec); ``http_mix`` picks each job's.
    # A result's length is checked against the upload as the service
    # decodes it: a short Ogg stream on one page comes back from the lavc
    # tier padded to its last block (as in the JAX package)
    codecs = [c.strip() for c in args.http_formats.split(",")]
    tmpd = tempfile.TemporaryDirectory(prefix="ars_torch_httpsoak_")
    blobs, decoded_frames = {}, {}
    for d in durations:
        n = int(d * rate)
        t = np.arange(n) / rate
        x = (0.35 * np.sin(2 * np.pi * 220.0 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        for c in codecs:
            path = os.path.join(tmpd.name, f"clip_{d}.{c}")
            wavio.write_audio(path, np.stack([x, 0.9 * x], axis=1), rate)
            with open(path, "rb") as f:
                blobs[(d, c)] = f.read()
            decoded_frames[(d, c)] = wavio.read(path)[0].shape[0]
    n_ir = int(0.4 * rate)
    env = np.exp(-np.arange(n_ir) / (0.1 * rate)).astype(np.float32)
    ir = 0.4 * rng.standard_normal((n_ir, 2)).astype(np.float32) * env[:, None]
    buf = io.BytesIO()
    wavio.write(buf, ir, rate)
    ir_blob = buf.getvalue()

    svc = _service(args)
    wd = _watchdog(svc, args, HTTP_METRIC).start()
    hsvc = RenderHTTPService(service=svc, host="127.0.0.1", port=0).start()

    def _req(method, path, body=None, headers=None):
        conn = HTTPConnection("127.0.0.1", hsvc.port, timeout=600)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    st, data = _req("POST", "/v1/upload", ir_blob, {"X-Filename": "ir.wav"})
    if st != 200:
        wd.stop()
        hsvc.stop()
        tmpd.cleanup()
        print(json.dumps({"metric": HTTP_METRIC, "error": f"IR upload: {st} {data[:160]!r}"}))
        return 1
    ir_remote = json.loads(data)["path"]

    def run_job(i, t_arrival):
        d, c, fmt = http_mix(i, durations, codecs)
        eq = i % 3 == 0
        extir = i % 5 == 4
        params = _soak_params(i, eq, extir)
        laps = [t_arrival]
        st, data = _req("POST", "/v1/upload", blobs[(d, c)], {"X-Filename": f"clip{i}.{c}"})
        laps.append(time.monotonic())
        if st != 200:
            return ("fail_upload", f"{st}: {data[:120]!r}", d)
        payload = {"input": json.loads(data)["path"], "seed": i, "metrics": i % 2 == 0,
                   "format": fmt, "params": params}
        if extir:
            payload["external_ir"] = ir_remote
        st, data = _req("POST", "/v1/jobs", json.dumps(payload).encode())
        laps.append(time.monotonic())
        if st == 503:
            return ("rejected", None, d)
        if st != 202:
            return ("fail_submit", f"{st}: {data[:160]!r}", d)
        jid = json.loads(data)["job_id"]
        while True:
            st, data = _req("GET", f"/v1/jobs/{jid}")
            s = json.loads(data).get("status")
            if s == "done":
                break
            if s in ("error", "cancelled"):
                return ("fail_job", data[:160].decode("utf-8", "replace"), d)
            time.sleep(0.25)
        laps.append(time.monotonic())
        st, data = _req("GET", f"/v1/jobs/{jid}/result")
        laps.append(time.monotonic())
        latency = laps[-1] - t_arrival  # the client's own decode is not the service's
        if st != 200:
            return ("fail_result", f"{st}: {len(data)} bytes", d)
        path = os.path.join(tmpd.name, f"result_{i}.{fmt}")
        with open(path, "wb") as f:
            f.write(data)
        try:
            audio, _ = wavio.read(path)
        finally:
            os.unlink(path)
        fault = result_fault(audio, expected_length(decoded_frames[(d, c)], rate,
                                                    RenderParams.from_preset_dict(params),
                                                    n_ir))
        if fault:
            return ("fail_result", fault, d)
        split = {k: b - a for k, a, b in zip(HTTP_SPLIT, laps, laps[1:])}
        return ("ok", {"latency_s": latency, "duration_s": d, "codec": c, "format": fmt,
                       **split}, d)

    def stop_all():
        wd.stop()
        hsvc.stop()
        tmpd.cleanup()

    # --- warm-up: one serialized job per signature, straight through HTTP ---
    t_warm = time.monotonic()
    warm_jobs = 0
    for i in range(2 * len(durations)):
        outcome = run_job(i, time.monotonic())
        if outcome[0] != "ok":
            stop_all()
            print(json.dumps({"metric": HTTP_METRIC, "failed": 1,
                              "error": f"warm-up job {i} failed: {outcome}"}))
            return 1
        warm_jobs += 1
    print(f"warmup ({warm_jobs} jobs over HTTP): {time.monotonic() - t_warm:.1f} s",
          file=sys.stderr)
    if args.warm_buckets:
        t_warm = time.monotonic()
        bucket_list = [int(b) for b in args.warm_buckets.split(",")]
        for di, d in enumerate(durations):
            clip = np.zeros(int(d * rate), np.float32)
            for wm in (False, True):
                p = RenderParams.from_preset_dict(_soak_params(di, di % 3 == 0, False))
                svc.warm(RenderJob(clip, rate, p, with_metrics=wm), sizes=bucket_list)
        print(f"warm buckets {bucket_list}: {time.monotonic() - t_warm:.1f} s",
              file=sys.stderr)

    lock = threading.Lock()
    jobs_ok: list = []
    failures: list = []
    rejected = 0
    audio_ok = 0.0
    rss_samples = [_rss_mb()]
    pinned_samples: list = []
    dir_samples: list = []
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(5.0):
            st_ = svc.stats()
            with lock:
                rss_samples.append(st_.get("rss_mb", _rss_mb()))
                pinned_samples.append(st_.get("pinned_mb", 0.0))
                try:
                    dir_samples.append((len(os.listdir(hsvc._uploads.dir)),
                                        len(os.listdir(hsvc._result_dir))))
                except OSError:
                    pass

    smp = threading.Thread(target=sampler, daemon=True)
    smp.start()

    pool = ThreadPoolExecutor(max_workers=args.http_workers)
    outstanding = []
    t0 = time.monotonic()
    deadline = t0 + args.soak
    i = warm_jobs
    submitted = 0
    while time.monotonic() < deadline:
        time.sleep(float(rng.exponential(1.0 / args.arrival_rate)))
        if time.monotonic() >= deadline:
            break
        outstanding.append(pool.submit(run_job, i, time.monotonic()))
        i += 1
        submitted += 1
    for fut in outstanding:
        try:
            kind, info, d = fut.result(timeout=3600)
        except Exception as e:  # noqa: BLE001 — a client thread's crash is a failure
            kind, info, d = "fail_client", repr(e), 0.0
        if kind == "ok":
            jobs_ok.append(info)
            audio_ok += d
        elif kind == "rejected":
            rejected += 1
        else:
            failures.append((kind, info))
    wall = time.monotonic() - t0
    pool.shutdown()
    stop_sampler.set()
    smp.join(timeout=10)
    stats = svc.stats()
    upload_files_end = len(os.listdir(hsvc._uploads.dir))
    result_files_end = len(os.listdir(hsvc._result_dir))
    stop_all()
    rss_samples.append(_rss_mb())

    lat = sorted(j["latency_s"] for j in jobs_ok)
    nd, nc = len(durations), len(codecs)
    out = {
        "metric": HTTP_METRIC,
        "formats": codecs,
        "mix": {"durations_s": durations, "upload_codecs": codecs, "result_formats": codecs,
                "rule": f"job i: duration i % {nd}, upload codec (i // {nd}) % {nc}, "
                        f"result format (i // {nd * nc}) % {nc}"},
        "soak_seconds": wall,
        "arrival_rate_hz": args.arrival_rate,
        "http_workers": args.http_workers,
        "submitted": submitted,
        "completed": len(lat),
        "failed": len(failures),
        "rejected_503": rejected,
        "audio_seconds": audio_ok,
        "throughput_x_realtime": audio_ok / wall if wall else 0.0,
        "latency_p50_s": _pct(lat, 0.50),
        "latency_p95_s": _pct(lat, 0.95),
        "latency_p99_s": _pct(lat, 0.99),
        # the client's split of each completed job: upload POST, job POST (the
        # upload's decode on the request thread), wait (queue, render, poll),
        # result GET (the result's encode on the request thread)
        "split_s": {k: _split_stats([j[k] for j in jobs_ok]) for k in HTTP_SPLIT},
        "request_thread_s_mean": (sum(j["submit_s"] + j["result_s"] for j in jobs_ok)
                                  / len(jobs_ok) if jobs_ok else 0.0),
        "slowest": sorted(jobs_ok, key=lambda j: -j["latency_s"])[:3],
        "jobs_done_service": stats["jobs_done"],
        "dispatch_s": stats["dispatch_s"],
        "fetch_s": stats["fetch_s"],
        "rss_start_mb": rss_samples[0],
        "rss_peak_mb": max(rss_samples),
        "rss_end_mb": rss_samples[-1],
        "rss_slope_last_half_mb_per_min": _slope_mb_per_min(rss_samples),
        "pinned_peak_mb": max(pinned_samples + [stats["pinned_mb"]]),
        "pinned_end_mb": stats["pinned_mb"],
        "upload_files_peak": max((u for u, _ in dir_samples), default=0),
        "upload_files_end": upload_files_end,
        "result_files_peak": max((r for _, r in dir_samples), default=0),
        "result_files_end": result_files_end,
        "fft_plans_end": stats["fft_plans"],
        "failures_sample": [f"{k}: {v}" for k, v in failures[:3]],
        "device": card(args.device),
    }
    print(json.dumps(out))
    return 1 if failures else 0


def run_soak(args, svc_kwargs=None, label="", extir_every=0) -> dict:
    """One soak arm: Poisson arrivals through a fresh RenderService.

    ``svc_kwargs`` overrides the service configuration (the --matrix arms
    pass ``ir_backend`` here); ``extir_every`` mixes one external-IR job per
    that many arrivals (they share one IR, so they micro-batch).  Returns
    the line's dict."""
    from ..params import RenderParams
    from ..serving import RenderJob
    from .bench_long import card

    rate = args.rate
    rng = np.random.default_rng(0x50AC)
    durations = [float(d) for d in args.soak_durations.split(",")]
    # one clip per duration; the per-job variation is the value sweep
    clips = {}
    for d in durations:
        n = int(d * rate)
        t = np.arange(n) / rate
        clips[d] = (0.35 * np.sin(2 * np.pi * 200.0 * t)
                    + 0.05 * rng.standard_normal(n)).astype(np.float32)
    # one shared external IR (0.5 s stereo decaying noise): external jobs
    # sharing the same IR bytes coalesce into one batch key
    n_ir = int(0.5 * rate)
    env = np.exp(-np.arange(n_ir) / (0.12 * rate)).astype(np.float32)
    ext_ir = 0.5 * rng.standard_normal((n_ir, 2)).astype(np.float32) * env[:, None]

    metric = SOAK_METRIC + (f" [{label}]" if label else "")
    svc = _service(args, **(svc_kwargs or {}))
    wd = _watchdog(svc, args, metric).start()

    def make_job(i: int, with_metrics=None, eq=None, extir=None):
        d = durations[i % len(durations)]
        if eq is None:
            eq = i % 3 == 0
        if with_metrics is None:
            with_metrics = i % 2 == 0
        if extir is None:
            extir = bool(extir_every) and i % extir_every == extir_every - 1
        p = RenderParams.from_preset_dict(_soak_params(i, eq, extir))
        job = RenderJob(clips[d], rate, p, seed=i, with_metrics=with_metrics,
                        external_ir=ext_ir if extir else None,
                        external_ir_rate=rate if extir else None)
        return job, expected_length(clips[d].shape[0], rate, p, n_ir)

    lock = threading.Lock()
    latencies: list = []
    failures: list = []

    def check(result, want, what):
        fault = result_fault(result.audio, want)
        if fault:
            with lock:
                failures.append(f"{what}: {fault}")

    # --- warm-up: one job per signature (duration × metrics × EQ × IR),
    # serialized, so the soak measures serving, not first-call plans ---
    t_warm = time.monotonic()
    warm_jobs = 0
    extir_arms = (False, True) if extir_every else (False,)
    for di in range(len(durations)):
        for wm in (False, True):
            for eq in (False, True):
                for xi in extir_arms:
                    job, want = make_job(di, with_metrics=wm, eq=eq, extir=xi)
                    check(svc.render(job, timeout=3600), want, f"warm-up job {warm_jobs}")
                    warm_jobs += 1
    print(f"warmup ({warm_jobs} signatures): {time.monotonic() - t_warm:.1f} s",
          file=sys.stderr)
    # the batch-size buckets traffic will form, per traffic-shaped signature
    if args.warm_buckets:
        t_warm = time.monotonic()
        bucket_list = [int(b) for b in args.warm_buckets.split(",")]
        for di in range(len(durations)):
            for wm in (False, True):
                for xi in extir_arms:
                    warmed = svc.warm(make_job(di, with_metrics=wm, extir=xi)[0],
                                      sizes=bucket_list)
        print(f"warm buckets {warmed} x {2 * len(durations) * len(extir_arms)} signatures: "
              f"{time.monotonic() - t_warm:.1f} s", file=sys.stderr)

    rejected = 0
    rss_samples = [_rss_mb()]
    queue_depths: list = []
    mem_samples: list = []
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(5.0):
            st = svc.stats()
            with lock:
                rss_samples.append(st.get("rss_mb", _rss_mb()))
                queue_depths.append(st["queued"])
                mem_samples.append(st)

    smp = threading.Thread(target=sampler, daemon=True)
    smp.start()
    n_warm_batches = len(svc.stats()["batch_sizes"])

    # --- Poisson arrivals for --soak seconds ---
    t0 = time.monotonic()
    deadline = t0 + args.soak
    submitted = 0
    audio_seconds = 0.0
    outstanding = 0
    drained = threading.Condition(lock)
    i = 0
    while time.monotonic() < deadline:
        time.sleep(float(rng.exponential(1.0 / args.arrival_rate)))
        if time.monotonic() >= deadline:
            break
        job, want = make_job(i)
        i += 1
        t_sub = time.monotonic()

        def done(fut, t_sub=t_sub, want=want, i=i):
            nonlocal outstanding
            err = fut.exception()
            if err is None:
                check(fut.result(), want, f"job {i - 1}")
            with lock:
                if err is not None:
                    failures.append(repr(err))
                else:
                    latencies.append(time.monotonic() - t_sub)
                outstanding -= 1
                drained.notify_all()

        try:
            fut = svc.submit(job)
        except RuntimeError:  # backpressure (HTTP 503)
            rejected += 1
            continue
        with lock:
            outstanding += 1
        fut.add_done_callback(done)
        # drop the future now: a retained future pins its result, which would
        # make the harness itself look like a service-side leak in the RSS
        del fut
        submitted += 1
        audio_seconds += len(job.audio) / rate
    with drained:  # drain without retaining any result
        drained.wait_for(lambda: outstanding == 0, timeout=3600)
    wall = time.monotonic() - t0
    stop_sampler.set()
    smp.join(timeout=10)
    stats = svc.stats()
    wd.stop()
    svc.stop()
    gc.collect()  # big results are mmap'd; RSS reflects real frees
    rss_samples.append(_rss_mb())

    lat = sorted(latencies)
    hist: dict = {}
    for s in stats["batch_sizes"][n_warm_batches:]:  # the soak's own dispatches
        hist[str(s)] = hist.get(str(s), 0) + 1
    curve = rss_samples
    if len(curve) > 24:
        step = (len(curve) - 1) / 23.0
        curve = [curve[int(round(k * step))] for k in range(24)]
    pinned = [s.get("pinned_mb", 0.0) for s in mem_samples] + [stats["pinned_mb"]]
    return {
        "metric": metric,
        "soak_seconds": wall,
        "arrival_rate_hz": args.arrival_rate,
        "submitted": submitted,
        "completed": len(lat),
        "failed": len(failures),
        "rejected_503": rejected,
        "audio_seconds": audio_seconds,
        "throughput_x_realtime": audio_seconds / wall if wall else 0.0,
        "latency_p50_s": _pct(lat, 0.50),
        "latency_p95_s": _pct(lat, 0.95),
        "latency_p99_s": _pct(lat, 0.99),
        "latency_max_s": lat[-1] if lat else 0.0,
        "dispatch_size_hist": hist,
        "queue_depth_max": max(queue_depths, default=0),
        "pipeline_depth": stats["pipeline_depth"],
        "dispatch_s": stats["dispatch_s"],
        "fetch_s": stats["fetch_s"],
        "rss_start_mb": rss_samples[0],
        "rss_mid_mb": rss_samples[len(rss_samples) // 2],
        "rss_peak_mb": max(rss_samples),
        "rss_end_mb": rss_samples[-1],
        "rss_curve_mb": curve,
        "rss_slope_last_half_mb_per_min": _slope_mb_per_min(rss_samples),
        "pinned_peak_mb": max(pinned),
        "pinned_end_mb": stats["pinned_mb"],
        "fft_plans_end": stats["fft_plans"],
        "device_allocated_end_mb": stats["device_allocated_mb"],
        "inflight_input_peak_mb": max(
            (s.get("inflight_input_bytes", 0) for s in mem_samples), default=0) / 1e6,
        "retained_result_peak_mb": max(
            (s.get("retained_result_bytes", 0) for s in mem_samples), default=0) / 1e6,
        "failures_sample": failures[:3],
        "device": card(args.device),
    }


def burst(args) -> int:
    """``--jobs`` concurrent jobs of one signature: warm, one warm-up burst,
    then the measured burst."""
    from ..params import RenderParams
    from ..serving import RenderJob
    from .bench_long import card

    rate = args.rate
    n = int(args.seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.default_rng(0)
    clips = [(0.4 * np.sin(2 * np.pi * (180 + 20 * i) * t)
              + 0.05 * rng.standard_normal(n)).astype(np.float32)
             for i in range(args.jobs)]
    # a value sweep across the burst: all jobs share one batch key
    params = [RenderParams(target_layout="Stereo",
                           diffusion=0.2 + 0.6 * (i / max(1, args.jobs - 1)),
                           x_pos=0.1 + 0.8 * (i / max(1, args.jobs)))
              for i in range(args.jobs)]
    wants = [expected_length(n, rate, p) for p in params]

    svc = _service(args)
    wd = _watchdog(svc, args, BURST_METRIC).start()
    failures: list = []

    def run_burst(tag: str) -> float:
        t0 = time.perf_counter()
        futs = [svc.submit(RenderJob(c, rate, p, seed=i, with_metrics=args.metrics))
                for i, (c, p) in enumerate(zip(clips, params))]
        for i, f in enumerate(futs):
            try:
                fault = result_fault(f.result(timeout=3600).audio, wants[i])
            except Exception as e:  # noqa: BLE001 — a failed job is counted, not fatal
                fault = repr(e)
            if fault:
                failures.append(f"{tag} job {i}: {fault}")
        dt = time.perf_counter() - t0
        print(f"{tag}: {dt:.3f} s for {args.jobs} jobs", file=sys.stderr)
        return dt

    # prepare every batch-size bucket of the signature: which bucket a group
    # lands in depends on arrival timing
    t0 = time.perf_counter()
    warmed = svc.warm(RenderJob(clips[0], rate, params[0], with_metrics=args.metrics))
    print(f"warm buckets {warmed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    run_burst("warmup")
    stats0 = svc.stats()
    dt = run_burst("measured")
    stats = svc.stats()
    wd.stop()
    svc.stop()
    out = {
        "metric": BURST_METRIC,
        "value": args.jobs * args.seconds / dt,
        "unit": "x realtime",
        "jobs": args.jobs,
        "job_latency_s": dt,
        "failed": len(failures),
        "batch_sizes": stats["batch_sizes"][-8:],
        "pipeline_depth": args.pipeline_depth,
        # the measured burst's phase totals (worker dispatch, completer fetch;
        # they overlap under pipelining, so the sum can exceed job_latency_s)
        "dispatch_s": stats["dispatch_s"] - stats0["dispatch_s"],
        "fetch_s": stats["fetch_s"] - stats0["fetch_s"],
        "pinned_mb": stats["pinned_mb"],
        "failures_sample": failures[:3],
        "device": card(args.device),
    }
    print(json.dumps(out))
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_serving", description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--rate", type=int, default=48000)
    ap.add_argument("--max-batch", type=int, default=48)
    ap.add_argument("--max-wait-ms", type=float, default=200.0)
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument("--exact-filters", dest="fast_filters", action="store_false",
                    default=True, help="exact-length filters (default: fast)")
    ap.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                    help="sustained-load soak: Poisson arrivals for this many seconds")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="soak mean arrival rate, jobs/s (Poisson)")
    # off the half-second bucket grid on purpose: padded EQ-on jobs exercise
    # the length-dynamic EQ under sustained load
    ap.add_argument("--soak-durations", default="5.3,14.7,44.9",
                    help="comma-separated clip durations (s) cycled through in the soak")
    ap.add_argument("--max-queued", type=int, default=64)
    ap.add_argument("--http", action="store_true",
                    help="soak THROUGH the HTTP layer: per-job upload → job POST → "
                         "status polling → result download")
    ap.add_argument("--http-formats", default=",".join(HTTP_FORMATS),
                    help="HTTP soak: comma-separated upload codecs and result formats "
                         "(wav, flac, ogg)")
    ap.add_argument("--http-workers", type=int, default=16,
                    help="HTTP soak: concurrent client lifecycles")
    ap.add_argument("--matrix", action="store_true",
                    help="run --soak seconds per arm of the service configuration "
                         "(bank with external-IR jobs, the plain IR path, both over a "
                         "data mesh)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="matrix: shards of the mesh arms' data mesh (default: the visible "
                         "cards, 1 on the CPU)")
    ap.add_argument("--extir-every", type=int, default=0,
                    help="soak: every Nth job renders through a shared external IR "
                         "(0 disables; the matrix's first arm defaults to 5)")
    ap.add_argument("--warm-buckets", default="2,4,8,16",
                    help="soak: comma-separated batch-size buckets to warm per traffic "
                         "signature ('' skips; one job per signature is always served first)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="dispatched groups in flight (1 = the serial worker)")
    ap.add_argument("--stall-timeout", type=float, default=600.0,
                    help="abort (exit 3, thread dump, error JSON) when neither the "
                         "batcher's counters nor process I/O move for this many seconds; "
                         "0 disables")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    from .bench_long import needs_card

    if args.mesh_devices is None:
        import torch

        args.mesh_devices = (torch.cuda.device_count()
                             if torch.device(args.device).type == "cuda" else 1)
    if args.matrix and args.soak <= 0:
        ap.error("--matrix needs --soak SECONDS (per-arm duration)")
    if args.http and args.soak <= 0:
        ap.error("--http needs --soak SECONDS")
    metric = (HTTP_METRIC if args.http else "serving soak matrix" if args.matrix
              else SOAK_METRIC if args.soak > 0 else BURST_METRIC)
    error = needs_card(args.device)
    if error:
        print(json.dumps({"metric": metric, "error": error}))
        return 1
    if args.matrix:
        return matrix(args)
    if args.http:
        return http_soak(args)
    if args.soak > 0:
        return soak(args)
    return burst(args)


if __name__ == "__main__":
    sys.exit(main())
