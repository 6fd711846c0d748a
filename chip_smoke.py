"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Drives the port's paths at full size and checks them:

- the main path — the batched internal-hall render that ``bench.py`` times
  for the JAX package (B=48 mono clips, 60 s at 48 kHz, Room hall, Stereo,
  EQ off, fast and exact filter modes) through ``render_batch``;
- the oracle-parity path — ``render(draws=..., return_metrics=True)`` through
  the injected-draws bank, and external IRs, held to the port's CPU path on
  the same draws (``tests/test_torch_cuda.py`` holds the same renders to the
  float64 oracle on the card);
- the metered, padded batch — ``render_batch(with_metrics=True,
  clip_lengths=..., pcm16_output=True)`` at B=48 × 60 s, EQ off and on;
- the headless CLIs — ``cli.render``, ``cli.render_dir`` and
  ``cli.analyzer`` on WAV files, with the binaural downmix and the
  polyphase resampler;
- the serving path — ``serving.RenderService`` (micro-batches over
  ``render_batch(async_results=True)``, one CUDA stream per in-flight
  group) and its HTTP job API ``serving.service.RenderHTTPService``;
- the product surfaces — ``app.api.process_audio_main_v41`` (the studio's one
  button), the 4-tab studio over its headless HTTP server, the visualizer's
  device STFT, the A/B profiler, the analyzer UI and the ``compat`` façade;
- long clips — ``parallel.streaming.render_streaming`` on a 30-minute clip
  and the routes to it: ``cli.render --stream``, long jobs in
  ``RenderService`` and its HTTP API;
- the tools — ``tools.bench`` (the port's bench line), ``tools.profile_exact``,
  ``tools.bench_long bank``, ``tools.bench_serving`` and
  ``tools.fuzz_campaign``, each through its ``main`` in this process;
- the codecs — FLAC, Ogg/Vorbis, MP3 and AAC / M4A (host code) on their way
  to and from the card through ``cli.render``, ``cli.render_dir`` and the
  HTTP job API, and ``tools.bench_codecs``;
- the device mesh, one card standing in for N devices
  (``make_mesh(devices=["cuda:0"] * N)``): the data-parallel
  ``render_batch`` and ``RenderService`` over it, the sequence-parallel
  ``render_long``, the partitioned convolution and both dry runs;
- the back half's kernels (``csrc/back_half.cu``) at the cells' shapes
  against their plain version.

Phases, one line each:

1. environment: torch/CUDA versions, card name and power limit, TF32 off;
2. build: compiles ``csrc/rir_bank.cu`` and ``csrc/back_half.cu`` (both
   launchers of each) with nvcc and,
   beside it in a thread, the codecs' host libraries with g++
   (``wavio.warm_native``: native PCM16, FLAC, Vorbis, the FFmpeg shim), so
   no timed call of a later phase pays for a build;
3. bank check: the hash-draws kernels' final IRs against their plain
   PyTorch version's on the card (bench shape with seeds ≥ 2^31; a
   multi-tile Cathedral IR of odd length; split_point 1 at B=1), one counted
   call (stats pass + write pass) per bank call;
3b. injected bank check: the same for the injected-draws kernels (bench
   shape B=48, each entry its own draws; Cathedral 346,809 samples;
   split_point 1 at length 4096; a degenerate-smoothing entry, flagged by
   kernel and plain version alike);
4. main path: fast and exact renders, one kernel launch each, output
   checks, clips 0 and 47 against the port's plain path on the CPU, PCM16;
4b. parity path: BASELINE configs 1-5 on one 60 s clip (1 and 3 also in
   fast mode; 2 through ``external_ir``, plus a 44.1 kHz IR), one injected
   launch per internal render, against the port's CPU path (plain
   ``synthesize``): ≤ 1e-4 max-abs, ≤ 0.01 LU, peak and RMS ≤ 0.01 dB;
4c. metered padded batch: mixed true lengths, EQ off (fast) and on (exact);
   clips 0 and 47 against the CPU path, masked metrics against the meter
   on the trimmed output.  Each batch runs cold and again, the EQ-on batch
   also on 48 new true lengths in the same bucket; each run prints its wall,
   the cuFFT plan-cache size and the free device memory, and the new lengths
   must add no plan (the length-dynamic EQ, ``filters.apply_shelf_eq_dynamic``,
   keys its plans on the bucket).  Then ``[4c eq]``: that EQ against its
   plain version ``apply_shelf_eq_padded`` at (48, 2, 2,951,999) with the
   batch's true lengths (≤ 2e-5, zero past each length), each cold with the
   plan cache emptied (wall, plans added, free-memory drop) and warm by CUDA
   events beside the bytes bound; ``[4c timing]``;
5. timing: realtime factor of both modes, unmetered and metered, on
   device-resident inputs (settle, then the median of 3); the meter alone;
   both banks: their kernels' device time (torch.profiler), the wrapper
   calls, ``fused_rir_bank`` whole (scalar upload included) and the scalar
   upload alone beside the plain versions (CUDA events, in turns plain,
   kernel, kernel, plain), at the bench shape, at B=1 and at the Cathedral
   shape (its injected noise overflows the 50 MB L2);
6. the CLIs, called in this process in a temporary directory: ``cli.render``
   on a 60 s, 48 kHz stereo clip (Cathedral 300, 5.1; plain, ``--binaural``,
   ``--sweep diffusion=0.2,0.5,0.8``), each written WAV equal bit for bit to
   ``encode_pcm16`` of the port's ``render`` / ``binauralize`` /
   ``render_batch`` on the card, the card's ``render`` within 1e-4 of the
   CPU's, the binaural mix also within 1e-4 of the CPU's, and the bank held
   to its plain version at each CLI shape and seed set (B=1 and B=3 at
   Cathedral 300, B=8 at render_dir's micro-batches), uncounted;
   ``cli.render_dir --batch 8 --metrics`` over 24 stems (mono and
   stereo, three length groups of about 30, 45 and 60 s), then
   ``--binaural`` over 8 of them, each output of length true + IR - 1 and
   its metrics within 0.01 LU of the meter on the file; ``cli.analyzer``
   ``analyze --true-peak``, ``normalize --target -16`` (measured again
   within 0.05 LU) and ``convert --samplerate 48000`` of a 44.1 kHz clip
   (``resample_poly`` on the card within 1e-5 of the CPU's, the file equal
   to its PCM16); the wall time of each call, the binaural table and mix
   and ``resample_poly`` on the card;
7. the render service on the card.  7a: a burst of 48 jobs (60 s, 48 kHz,
   mono, Room, Stereo; diffusion, air, mix and positions swept, distinct
   seeds and true lengths, metrics on) into ``RenderService(max_batch=48,
   pcm16_output=True)``, with fast and with exact filters, at pipeline
   depth 1 and 2, after one warm burst per stream: every job's PCM16 and
   metrics equal, bit for bit, its row of one direct ``render_batch`` on
   the card, depth 2 equals depth 1, and a float32 burst is held to the
   port's CPU path on jobs 0 and 47 (≤ 1e-4); then four bursts queued at
   once, twice (the sustained rate); then ``warm()`` called from this
   thread while two bursts are queued or in flight, three times, every job
   still equal to its direct row.  7b: 64 jobs from 8 threads —
   20-60 s in four half-second buckets, Room and Cathedral 300, Stereo and
   5.1, metrics on and off, some with shelf EQ at a padded length, 8
   sharing one external IR — into ``max_batch=16, max_wait_ms=100``, cold
   and again: every future resolves, the groups split by key, each result
   is within 2e-5 (PCM16 1 LSB, 0.01 LU) of a solo ``render`` on the card;
   a mono external IR and an empty clip are refused at ``submit``, a clip
   past ``streaming_threshold_s`` at ``warm`` (an unknown layout
   name is no error: it falls back to the default layout, as in the
   reference); a cancelled queued job gives its bytes back.  7c: the HTTP
   API on 127.0.0.1 — four 60 s WAVs and a stereo IR uploaded; a params
   job, a preset job and an external-IR job polled to the end, their WAV
   bytes equal to ``wavio.write`` of the direct render's PCM16; a queued
   job deleted; flac and ogg jobs accepted (202) and cancelled; 400 (an
   unknown format among them), 403, 404, 409, 410 and 413 answered.  The bank is
   held to its plain version at B in {1, 2, 4, 8, 16, 32, 48} × 72,000 and
   at 7b's Cathedral 300 groups.  ``[7 timing]``: the walls and
   audio-seconds per second of each arm, ``dispatch_s`` and ``fetch_s``
   per group, one group's copies up and down by CUDA events (page-locked
   and asynchronous against pageable and blocking), the time
   ``render_batch(async_results=True)`` takes to return against the end of
   ``fetch()``, the device's busy share of a depth-2 burst
   (torch.profiler), 7b's latencies, plan-cache size and memory, a cold
   bucket against a warm one (``warm()``), the HTTP walls.  Every wait on a
   future has a timeout;
8. the product surfaces on a 60 s, 48 kHz stereo WAV, the process-wide
   device set to the card.  8a: ``process_audio_main_v41(path, None, None,
   *controls, seed=3)`` with the 16 controls in ``config.PRESET_KEYS`` order
   for Room / Stereo, for Cathedral 300 / 5.1 with shelf EQ (bass 1.6, treble
   0.7) and for an external stereo IR: each written WAV equal bit for bit to
   ``wavio``'s PCM16 of the port's ``pipeline.render`` on the card with the
   same params and seed, the metrics string to ``metrics_string`` of that
   render's metrics, one counted bank call per internal render, the bank held
   to its plain version at both shapes (B=1), the first case again with the
   CPU as the default device (PCM16 within 1 LSB, ``render`` ≤ 1e-4), and two
   error strings of the contract.  8b: ``compute_spectrogram(use_device=
   True)`` on channel 0 of the 5.1 render (3,155,898 samples, nperseg 4096,
   1,539 frames) against ``device="cpu"`` and ``scipy.signal.spectrogram``:
   ≤ 1e-5 of the matrix's maximum, the gap in dB above the plot's 1e-10
   floor, the plot's color limits within 0.01 dB.  8c: ``compat`` chained as
   the reference's monolith chains it (IR, split convolve with EQ and air,
   pan, map to 5.1, 7.1 and 5.1.2, external-IR convolve, LP filter,
   metrics), each call against ``device="cpu"`` (≤ 1e-4), the chain's end
   against 8a's render.  8d: ``StudioHTTPServer(build_demo(store))`` on
   127.0.0.1: upload, the process button through ``POST /event`` while
   ``/state`` is polled, ``GET /file`` equal to 8a's bytes, 403 outside the
   allowlist, the profiler report on (input, output), the analyzer UI's
   ``do_analyze`` and ``do_normalize`` on the 6-channel file; and only where
   ``importlib.util.find_spec`` finds matplotlib / PIL, the visualizer PNGs
   and the startup marker (the line says which ran; every step that touches
   the card runs regardless).  ``[8 timing]``: each call's wall and its split
   (read, ``render``, clip + encode + write, player copy), the STFT's times,
   the HTTP walls;
9. long clips: a 30-minute mono clip at 48 kHz (``tools/bench_long.py``'s:
   5.1, room 200, seed 1, 30 s chunks, metrics on).  9a ``render_streaming``
   fast, exact and exact + EQ (bass 1.6, treble 0.7) against the single-shot
   ``render`` of the same clip (exact ≤ 1e-4, fast ≤ 1e-3, metrics ≤ 0.01
   LU / dB), PCM16 on the card equal to ``wavio``'s, ``bench_long``'s three
   realtime factors for fast and exact, the stage split of a render by CUDA
   events and the card's busy share; 9b a 5-minute clip in 30 s and 7.3 s
   chunks within 1e-5; 9c the exact-length EQ and air (Bluestein at m =
   2^28) and cuFFT's own pair at the render's length against float64 cuFFT,
   their times and the memory their plans hold beside the allocator; 9d a
   90 s clip on the card against the CPU (≤ 2e-5, PCM16 1 LSB); 9e a
   12-minute WAV through ``cli.render --stream`` (bytes equal to the direct
   call's), one 12-minute job among 48 × 60 s jobs in ``RenderService``
   (the long one a group of its own, bytes equal to the direct call's, the
   short ones to their ``render_batch`` rows) and through the HTTP API;
   9f the bank at the streaming shapes; 9g the peak allocated memory and
   the memory beside the allocator of single-shot and streaming exact + EQ
   renders at 30 and 60 min, Stereo and 5.1.  ``[9 timing]``;
10. the tools, each line printed as ``[10x name] {...}``: 10a ``tools.bench``
   at its defaults (B=48 × 60 s, fast and exact; its values > 0 and its
   ``settled_*`` keys present, printed beside phase 5's realtime factors);
   10b ``tools.profile_exact`` (its stage chain within 1e-5 of the whole
   exact render); 10c ``tools.bench_long bank --batch 16`` (the bank's and
   the plain IR path's renders within 1e-4); 10d ``tools.bench_serving``:
   the burst of 48 × 60 s, ``--soak 15``, ``--matrix --soak 8``, ``--http
   --soak 15 --http-formats wav`` (WAV uploads and results at 2 jobs/s) and
   ``--http --soak 20 --arrival-rate 0.5`` (WAV, FLAC and Ogg uploads and
   results, each codec on every clip length; each job's wall split into
   upload, job POST, wait and result GET, the slowest jobs printed), each
   with no failed job (every result of its true length and not silent); 10e ``tools.fuzz_campaign`` parity 6, batch 3 and
   streaming 3 on the card with no finding.  Every (shape, batch) the bank
   was called with in the phase is held again, kernel against plain.
   ``[10 timing]``;
11. the codecs, in a temporary directory.  11a the tiers: the native pcm /
   flac / vorbis libraries built with g++ in phase 2 (a failed build fails
   the run); libmpg123, libmp3lame, the FFmpeg shim, soundfile and the
   ffmpeg binary are reported, and where one is absent the JAX package's
   error for its format is checked; a failed shim build is not tried again
   (its ``.failed`` marker answers, timed).  11b a 60 s, 48 kHz stereo clip (two of
   ``tools/profile_render.bench_clips``) as FLAC, Ogg and (with libmp3lame)
   MP3, each decoded, rendered on the card (Cathedral 300, 5.1, seed 3)
   within 2e-5 of the CPU's render, and through ``cli.render`` into .flac
   (within 1 LSB of the card's PCM16) and .ogg, the FLAC input also into
   .mp3 (``--binaural``) and .m4a where their libraries load; each lossy
   file decodes at its length and meets the JAX suites' SNR bound (Vorbis
   28 dB, MP3 25 dB, AAC 15 dB).  11c ``cli.render_dir --batch 4`` over WAV,
   FLAC, Ogg and AIFF files (and MP3 / M4A) with a corrupt FLAC, which is
   skipped with the JAX package's message; every good file rendered at
   true + IR − 1; ``cli.render`` on a FLAC cut mid-stream exits 1 with
   "FLAC-Datei beschädigt oder abgeschnitten".  11d the HTTP job API with
   FLAC and Ogg uploads and flac / wav / ogg results, each decoded at its
   length and not silent, the FLAC result equal to the WAV one; an unknown
   format answers 400.  11e ``tools.bench_codecs --lengths 60`` (its lines
   printed) and the fuzz ``codec`` and ``encode`` modes, 12 cases each, no
   finding.  The bank is held to its plain version at every (shape, batch)
   the phase called it with.  ``[11 timing]``;
12. the device mesh on one card standing in for N devices (a line says so;
   N shards of one card are not N cards).  12a the data-parallel
   ``render_batch`` of B=48 × 60 s (Room, Stereo, EQ 1.0, bank) over
   ``make_mesh(data=4)``, fast and exact, against the meshless render (≤ 1e-6;
   the bank launched once per shard), then metered + PCM16 + padded clips with
   EQ on (1 LSB, metrics ≤ 1e-5), each timed against the meshless wall in
   turns; 12b ``render_long`` of 60 s at 48 kHz (5.1, room 120, bass 1.6,
   treble 0.7, seed 3, metered — ``tests/test_long_render.py``'s render-scale
   case) at block 8 and 4, and 7.1 at block 4, against the single-shot exact
   ``render`` (≤ 1e-3) and the single-device meter (0.02 LU, 1e-3 dB), with
   walls and peak memory (every shard on the one card); 12c
   ``partitioned_convolve`` of (2, 2,951,999) with the main path's IR pair at
   block 4 against ``convolve_full`` (≤ 1e-5 of the peak); 12d
   ``RenderService(device_mesh=data 4)`` on a burst of 48 × 60 s jobs, each
   bit-equal to its row of the direct mesh ``render_batch``, then
   ``tools.bench_serving --matrix --soak 5 --mesh-devices 4`` with its mesh
   arms; 12e ``graft_entry.dryrun_multichip(8, devices=["cuda:0"] * 8)`` and
   ``tools.dryrun_distributed --device cuda`` (two gloo processes on the one
   card).  The bank is held to its plain version at every (shape, batch) the
   phase called it with.  ``[12 timing]``;
13. the back half's kernels (``ops/back_half_cuda.back_half``) on the
   render path's own inputs at B=48 × 2,951,999 Stereo, at B=1 and at
   B=48 × 3,155,898 5.1 with the EQ hook (the identity, so that only the
   kernels' work is timed); each also with the wet signal ×4: bit-equal to
   ``back_half_plain`` (``torch.equal``), counted once a call, CUDA-event
   times in turns with the plain version, the split by pass
   (torch.profiler), the bytes bound and the share, and how many clips
   each normalization scales.  ``[13 back half] ...`` lines, ``[13 timing]``.

Development options (a run with either prints no result line):
``--only 8`` … ``--only 13`` runs phases 1, 2 and that phase;
``--rehearse-cpu SECONDS`` walks phases 4c and 8 to 12's control flow on the
CPU at a short clip length.

Then one JSON line listing the kernels (each with its bound at this run's
shape: bytes over 3.35 TB/s against operations over 67 TFLOP/s, the
H100 SXM's published rates), the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.  Any failure raises: the
exit code is non-zero and no result line is printed.  Without a CUDA device,
or without the rest of the checkout, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BATCH = 48
DURATION_S = 60.0
RATE = 48000
BANK_TOL = 2e-5  # kernel vs plain bank on the card: float round-off (sum order, expf/powf ulps)
SERVE_TOL = 2e-5  # a served job vs its solo render on the card: the padded bucket's cuFFT lengths vs the true ones
RENDER_TOL = 1e-4  # card vs CPU render: cuFFT vs pocketFFT float32 over 3·2^20 and 2,951,999 points
EQ_TOL = 2e-5  # 4c: the length-dynamic EQ vs its exact-length plain version, unit-peak rows
LU_TOL = 0.01  # card vs CPU meter, masked vs trimmed (PARITY.md item 2's bound)
DB_TOL = 0.01  # sample peak and RMS, dB
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
PEAK_F32_S = 67e12  # float32 outside the tensor cores, same source
CLI_SECONDS = 60  # phases 6 and 8: the one clip (and phase 6's 44.1 kHz clip to convert)
STFT_TOL = 1e-5  # device STFT power vs the CPU's and scipy's, as a share of the matrix's maximum
STEM_SECONDS = (30, 45, 60)  # phase 6: the three length groups of the stems
LONG_MINUTES = 30.0  # phase 9: tools/bench_long.py's clip
STREAM_CHUNK_S = 30.0  # phase 9: its chunks
STREAM_TOL = 1e-4  # exact streaming vs single-shot (tests/test_streaming.py:254, :299); 9c vs float64
FAST_AIR_TOL = 1e-3  # fast streaming vs single-shot exact: the fast-air contract
INVARIANCE_TOL = 1e-5  # two chunk sizes: the overlap-add is exact, float32 round-off only
CARD_CPU_TOL = 2e-5  # a 90 s streaming render, card vs CPU
MESH_SHARDS = 4  # phase 12a / 12d: make_mesh(data=4) on one card
LONG_MESH_S = 60.0  # phase 12b: the JAX package's render-scale long render (tests/test_long_render.py)
MESH_TOL = 1e-6  # 12a mesh vs meshless: a shard's cuFFT plans are made for B/4 rows, not B
MESH_METRIC_TOL = 1e-5  # 12a metrics, LU / dB
LONG_TOL = 1e-3  # 12b vs the single-shot exact render: block-grid air and the distributed EQ
LONG_LU_TOL = 0.02  # 12b sharded meter vs the single-device meter (tests/test_long_render.py)
LONG_DB_TOL = 1e-3  # 12b peak and RMS, dB
CONV_TOL = 1e-5  # 12c partitioned vs whole convolution, relative to the peak (float32 FFTs of 2^19..2^22)


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
    """bench.py's protocol, as ``tools.bench.settle_and_median`` runs it: one
    warm-up, then calls until two consecutive samples agree within 20%, then
    the median of ``samples`` timed runs (host clock + sync) → (median, the
    settle samples, the timed samples)."""
    from audio_raytracing_studio_tpu_torch.tools.bench import settle_and_median

    result = settle_and_median(fn, torch.cuda.synchronize, settle_max, samples)
    return result["wall_s"], result["settle_runs_s"], result["runs_s"]


def bank_bound(shape, batch: int, injected: bool) -> dict:
    """The least time the card could take for one bank call at this shape:
    the bytes it must move (each input read once, each output written once)
    over the memory rate against its operations over the float32 rate —
    per late sample the w-tap sum, the mean, the envelope (one multiply, one
    expf counted as one operation) and three scale multiplies, plus for hash
    draws one lowbias32 (12 integer operations, counted at the same rate)."""
    late = batch * shape.late_length
    nbytes = 8 * batch * shape.length + 16 * batch  # early + late out, the scalar table in
    if injected:
        nbytes += 8 * batch * 80 + 4 * batch * max(1, shape.late_length) + 4 * batch
    else:
        nbytes += 4 * batch  # seeds
    ops = late * (shape.noise_smooth_width + 6) + (0 if injected else 12 * late)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def device_ms(torch, fn, iters: int = 20) -> dict:
    """Device time per call of each bank kernel ``fn`` launches, by name
    (torch.profiler's CUDA activity), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per = {}
    for _ in range(3):  # a profiling window now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            for name in ("bank_stats_kernel", "bank_write_kernel"):
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
                    per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if per:
            break
    check(len(per) == 2, f"the profiler saw the bank kernels {sorted(per)} on the device")
    return {"ms": per["bank_stats_kernel"] + per["bank_write_kernel"],
            "stats_pass_ms": per["bank_stats_kernel"], "write_pass_ms": per["bank_write_kernel"]}


def turns(torch, kernel_fn, plain_fn, kernel_iters=50, plain_iters=10):
    """Device times of a kernel and its plain version in turns (plain,
    kernel, kernel, plain) after a warm-up → (kernel ms, plain ms, runs)."""
    for fn in (kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    plain_a = cuda_ms(torch, plain_fn, plain_iters)
    kernel_a = cuda_ms(torch, kernel_fn, kernel_iters)
    kernel_b = cuda_ms(torch, kernel_fn, kernel_iters)
    plain_b = cuda_ms(torch, plain_fn, plain_iters)
    return ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2,
            {"plain": [plain_a, plain_b], "kernel": [kernel_a, kernel_b]})


def hold_bank(np, torch, bank, label: str, shape, ir_scalars, seeds) -> list:
    """The hash-draws kernels' final IRs against their plain version's on
    the card for these seeds and this scalar table (one value or a (B,)
    array per field) → [max-abs early, max-abs late], each ≤ BANK_TOL; the
    call must be counted once."""
    from audio_raytracing_studio_tpu_torch.ops import ir_synth

    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).cuda()
    scal = ir_scalars.table(len(seeds), "cuda")
    before = bank.launch_count
    kern = bank._rir_block_cuda(seeds_t, scal, shape)
    plain = bank._rir_block_plain(seeds_t, scal, shape)
    torch.cuda.synchronize()
    check(bank.launch_count == before + 1, f"{label}: bank call was not counted once")
    errs = [(k - q).abs().max().item() for k, q in zip(kern, plain)]
    check(all(np.isfinite(errs)) and max(errs) <= BANK_TOL,
          f"{label} bank kernel vs plain {errs} > {BANK_TOL}")
    return errs


def injected_draws(bank, shape, batch: int, seed: int, degenerate=()):
    """Seeded NumPy draws per entry in the injected bank's layout, on the
    card; entries in ``degenerate`` get ±1e-4 alternating noise, which the
    10-tap smoothing cancels (std(smoothed) ≤ 1e-6 → raw-noise fallback)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    hi = max(2, shape.actual_max_early_delay)
    delays = rng.integers(1, hi, size=(batch, bank.MAX_REFLECTIONS))
    strengths = rng.uniform(0.3, 0.8, size=(batch, bank.MAX_REFLECTIONS))
    noise = rng.uniform(-1.0, 1.0, size=(batch, max(1, shape.late_length)))
    for b in degenerate:
        noise[b] = np.where(np.arange(noise.shape[1]) % 2 == 0, 1e-4, -1e-4)
    return [torch.from_numpy(a).cuda() for a in bank.pack_draws(shape, delays, strengths, noise)]


def check_metrics(got: dict, want: dict, what: str) -> list:
    """|Δ| of LUFS, peak and RMS (equal infinities count as 0), each held to
    its tolerance."""
    d = [0.0 if float(got[k]) == float(want[k]) else abs(float(got[k]) - float(want[k]))
         for k in ("lufs", "true_peak_dbfs", "rms_dbfs")]
    check(d[0] <= LU_TOL and d[1] <= DB_TOL and d[2] <= DB_TOL,
          f"{what}: metrics {got} vs {want}")
    return d


def parity_phase(np, pipeline, bank, mono) -> dict:
    """BASELINE configs 1-5 on one 60 s clip through the card's parity path
    (``render(draws=...)`` → the injected kernel; config 2 through
    ``external_ir``), each held to the port's CPU path on the same draws,
    which runs the plain ``synthesize`` and the plain meter.  The float64
    oracle comparison at these shapes is ``tests/test_torch_cuda.py``'s."""
    from audio_raytracing_studio_tpu_torch import IRDraws, RenderParams

    rng = np.random.default_rng(0x0C0FFEE)
    n_ir = 4800  # tests/test_parity.py's config-2 IR
    ir = (rng.standard_normal((n_ir, 2)) * np.exp(-np.arange(n_ir) / 800.0)[:, None] * 0.3)
    ir = ir.astype(np.float32)
    ir[0] = 1.0
    ir44 = (rng.standard_normal((2205, 2)) * 0.2).astype(np.float32)
    configs = [
        ("config1", RenderParams(target_layout="Stereo"), False, None),
        ("config1", RenderParams(target_layout="Stereo"), True, None),
        ("config2_external", RenderParams(use_external_ir=True, dry_wet=0.7,
                                          dry_wet_kill_start=0.4, bass_gain=1.6,
                                          treble_gain=0.6, target_layout="Stereo"),
         False, (ir, None)),
        ("config2_ir44k1", RenderParams(use_external_ir=True, target_layout="Stereo"), False,
         (ir44, 44100)),
    ]
    cathedral = RenderParams(hall_type="Cathedral", room_size=600.0, air_absorption=0.5,
                             diffusion=0.8, target_layout="Stereo")
    configs += [("config3", cathedral, False, None), ("config3", cathedral, True, None),
                ("config4_51", RenderParams(x_pos=0.2, y_pos=0.8, z_pos=0.3,
                                            target_layout="5.1 (Standard)"), False, None),
                ("config5_71", RenderParams(target_layout="7.1 (Surround)", z_pos=0.7),
                 False, None),
                ("config5_512", RenderParams(target_layout="5.1.2 (Atmos Light)", z_pos=0.7),
                 False, None)]
    cpu_s = 0.0
    internal = 0
    worst = 0.0
    for name, p, fast, external in configs:
        label = f"{name} {'fast' if fast else 'exact'}"
        if external is None:
            geometry = pipeline._internal_static(p, RATE, 1, False)[0]
            kw = dict(draws=IRDraws.sample(np.random.default_rng(123), geometry),
                      fast_filters=fast)
        else:
            kw = dict(external_ir=external[0], external_ir_rate=external[1])
        before = bank.injected_launch_count
        t0 = time.perf_counter()
        out, metrics = pipeline.render(mono, RATE, p, return_metrics=True, device="cuda", **kw)
        card_s = time.perf_counter() - t0
        launched = bank.injected_launch_count - before
        check(launched == (external is None),
              f"{label}: {launched} injected launches, expected {int(external is None)}")
        internal += external is None
        t0 = time.perf_counter()
        ref, ref_metrics = pipeline.render(mono, RATE, p, return_metrics=True, device="cpu",
                                           **kw)
        host_s = time.perf_counter() - t0
        cpu_s += host_s
        check(out.shape == ref.shape, f"{label}: shape {out.shape} vs CPU {ref.shape}")
        check(bool(np.isfinite(out).all()), f"{label}: non-finite output")
        err = float(np.abs(out - ref).max())
        check(err <= RENDER_TOL, f"{label}: card vs CPU max-abs {err} > {RENDER_TOL}")
        worst = max(worst, err)
        d = check_metrics(metrics, ref_metrics, label)
        print(f"[4b parity] {label}: {out.shape} card vs CPU max-abs {err:.3e} "
              f"lufs {metrics['lufs']:.4f} (CPU {ref_metrics['lufs']:.4f}, d {d[0]:.2e} LU) "
              f"peak d {d[1]:.2e} dB rms d {d[2]:.2e} dB; card {card_s:.2f} s, "
              f"CPU {host_s:.2f} s", flush=True)
    print(f"[4b parity] {len(configs)} renders ({internal} through the injected kernel), "
          f"worst card vs CPU {worst:.3e}, CPU path total {cpu_s:.1f} s", flush=True)
    return {"cpu_s": cpu_s, "internal_renders": internal}


def card_state(torch, device) -> dict:
    """After a synchronize: the card's cuFFT plan-cache size, its free memory
    and the bytes in use beside PyTorch's allocator (GB); zeros on the CPU."""
    if torch.device(device).type != "cuda":
        return {"plans": 0, "free_gb": 0.0, "outside_gb": 0.0}
    torch.cuda.synchronize()
    return {"plans": torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()].size,
            "free_gb": torch.cuda.mem_get_info()[0] / 1e9,
            "outside_gb": outside_allocator(torch) / 1e9}


def clear_plans(torch, device) -> None:
    """Empty the cuFFT plan cache and the allocator's free blocks (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()].clear()
        torch.cuda.empty_cache()


def eq_hold(np, torch, filters, n0s, length: int, device: str) -> dict:
    """The length-dynamic EQ against its plain version (one exact-length
    pair per distinct true length) at the metered batch's shape: B rows of
    (2, length) seeded noise, unit-peak on [0, n0) and zero past it, bass
    1.6, treble 0.7.  Each runs cold (the plan cache emptied first), then
    warm by CUDA events; their outputs within EQ_TOL, the dynamic one
    exactly zero past each n0."""
    batch = len(n0s)
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((batch, 2, length), generator=gen, device=device)
    n0_t = torch.tensor(n0s, device=device)[:, None, None]
    past = torch.arange(length, device=device) >= n0_t
    x.masked_fill_(past, 0.0)
    x /= x.abs().amax(dim=(1, 2), keepdim=True)
    bg = torch.full((batch,), 1.6, device=device)
    tg = torch.full((batch,), 0.7, device=device)
    rows = [filters.eq_dyn_host(n0, RATE) for n0 in n0s]
    arms = {
        "dynamic": lambda: filters.apply_shelf_eq_dynamic(
            x, bg, tg, filters.EQDyn.stack(rows, device)),
        "plain": lambda: filters.apply_shelf_eq_padded(x, RATE, bg, tg, n0s),
    }
    on_card = torch.device(device).type == "cuda"
    out, result = {}, {}
    for name, fn in arms.items():
        clear_plans(torch, device)
        before = card_state(torch, device)
        t0 = time.perf_counter()
        out[name] = fn()
        if on_card:
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        after = card_state(torch, device)
        if on_card:
            warm_ms = cuda_ms(torch, fn, 3)
        else:  # a CPU rehearsal: host clock, no device number
            t0 = time.perf_counter()
            fn()
            warm_ms = (time.perf_counter() - t0) * 1e3
        result[name] = {"cold_s": cold, "warm_ms": warm_ms,
                        "plans_added": after["plans"] - before["plans"],
                        "free_drop_gb": before["free_gb"] - after["free_gb"],
                        "outside_gb": after["outside_gb"]}
    err = float((out["dynamic"] - out["plain"]).abs().max())
    check(err <= EQ_TOL, f"4c EQ: dynamic vs plain max-abs {err} > {EQ_TOL}")
    check(not out["dynamic"].masked_select(past).any(), "4c EQ: dynamic not zero past n0")
    bound_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES_S * 1e3
    d, q = result["dynamic"], result["plain"]
    print(f"[4c eq] apply_shelf_eq_dynamic vs apply_shelf_eq_padded at ({batch}, 2, {length}), "
          f"{len(set(n0s))} true lengths: max-abs {err:.3e} (tol {EQ_TOL}); cold (plan cache "
          f"emptied) {d['cold_s']:.3f} s, {d['plans_added']} plans, free -{d['free_drop_gb']:.2f} "
          f"GB vs plain {q['cold_s']:.3f} s, {q['plans_added']} plans, free "
          f"-{q['free_drop_gb']:.2f} GB (beside the allocator {q['outside_gb']:.2f} GB); warm "
          f"{d['warm_ms']:.2f} ms vs {q['warm_ms']:.2f} ms, bound {bound_ms:.3f} ms (bytes)",
          flush=True)
    del x, out
    clear_plans(torch, device)
    return {"max_abs": err, "bound_ms": bound_ms, **result}


def back_half_bound(batch: int, n_in: int, n: int, channels: int, eq: bool) -> dict:
    """The least time the back half could take at this shape: dry (B, 2,
    n_in) and wet (B, 2, n) read once, the (B, channels, n) layout written
    once and, with the EQ, the mix written and read back once more; against
    the operations of one pass over the samples (mix 6, pan 18, map and the
    three normalizations about 4 per output channel) at the float32 rate.
    ``design_ms``: the bytes of the kernels' four passes (each re-reads its
    input; with the EQ the mix reads dry and wet once and A-D the EQ'd mix)."""
    dry, wet, out = 8 * batch * n_in, 8 * batch * n, 4 * batch * channels * n
    nbytes = dry + wet + out + (2 * wet if eq else 0)
    design = (dry + 2 * wet + 4 * wet + out) if eq else (4 * (dry + wet) + out)
    ops = batch * n * (24 + 4 * channels)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "design_bytes": design,
            "design_ms": 1e3 * design / PEAK_BYTES_S}


def back_half_scales(torch, filters, spatial, audio, wet, scal, layout, rate, eq) -> list:
    """How many clips each of the three normalizations rescales (max > 1) or
    zeroes (max < 1e-9): the plain chain's maxima, stage by stage."""
    dry = torch.nn.functional.pad(audio, (0, wet.shape[-1] - audio.shape[-1]))
    mixed = (scal.dry_factor * (1.0 - scal.dry_wet))[:, None, None] * dry \
        + scal.dry_wet[:, None, None] * wet
    stages = [eq(mixed) if eq is not None else mixed]
    six = spatial.apply_pan(filters.conditional_peak_normalize(stages[0]),
                            spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos))
    stages.append(six)
    stages.append(spatial.map_layout(filters.conditional_peak_normalize(six), layout, rate,
                                     scal.z_pos))
    fired = []
    for x in stages:
        m = x.abs().amax(dim=(1, 2))
        fired.append({"scaled": int((m > 1.0).sum()), "zeroed": int((m < 1e-9).sum())})
    return fired


def back_half_split(torch, fn, iters: int = 5) -> dict:
    """Device ms per call of each of the back half's kernels (pass A-D, the
    EQ's mix), by torch.profiler, after a warm-up call."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per = {}
    for _ in range(3):  # a profiling window now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            found = re.search(r"back_half_kernel<(\d+), (true|false), (\d)>", e.name)
            key = ("pass " + "ABCD"[int(found.group(3))] if found
                   else "mix" if "mix_kernel" in e.name else None)
            if key:
                per[key] = per.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if per:
            break
    check("pass D" in per, f"the profiler saw the back half's kernels {sorted(per)}")
    return per


def back_half_phase(np, torch, clips) -> dict:
    """Phase 13: the back half's kernels at the cells' shapes, their inputs
    taken from the render path itself (``_batched_internal`` up to the back
    half): B=48 × 2,951,999 Stereo from mono (batch48), the same at B=1, and
    B=48 × 3,155,898 5.1 after the exact EQ (the padded cell's shape, the EQ
    replaced by the identity for the timing so that only the kernels' work
    counts).  Each: bit-equal to the plain version (``torch.equal``), the
    launch count, the kernels' time by CUDA events in turns with the plain
    version, the split by pass, the bound and the share, and which
    normalizations fire on these inputs; then the same with the wet signal
    ×4, where every clip takes passes B and C."""
    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import back_half_cuda, filters, ir_synth, spatial
    from audio_raytracing_studio_tpu_torch.parallel import sharding

    n_in = int(DURATION_S * RATE)
    cells = (
        ("batch48", RenderParams(target_layout="Stereo"), BATCH, True),
        ("batch48_b1", RenderParams(target_layout="Stereo"), 1, True),
        ("padded", RenderParams(hall_type="Cathedral", room_size=300.0, bass_gain=1.6,
                                treble_gain=0.7, target_layout="5.1 (Standard)"), BATCH, False),
    )
    result = {}
    for label, p, batch, mono in cells:
        setup = pipeline.build_internal_setup(p, RATE, n_in)
        host = clips[:batch] if mono else np.stack([clips[:batch], clips[::-1][:batch]], -1)
        audio = torch.from_numpy(
            np.stack([pipeline._ensure_stereo_host(c).T for c in host])).cuda()
        ir_sc = ir_synth.IRScalars.stack([setup.ir_scalars] * batch)
        scal = pipeline.MixScalars.stack([setup.mix_scalars] * batch, "cuda")
        seeds = torch.arange(batch, dtype=torch.int32, device="cuda")
        taken = {}
        real = back_half_cuda.back_half

        def capture(audio_, wet, scal_, layout, rate, eq=None):
            taken.update(wet=wet, layout=layout, eq=eq)
            return real(audio_, wet, scal_, layout, rate, eq)

        pipeline.back_half_cuda.back_half = capture
        try:
            sharding._batched_internal(audio, seeds, ir_sc, scal, setup.ir_shape, setup.spec)
        finally:
            pipeline.back_half_cuda.back_half = real
        wet, layout = taken["wet"], taken["layout"]
        eq_on = taken["eq"] is not None
        check(eq_on == setup.spec.eq_on, f"{label}: the EQ hook {eq_on}")
        channels = len(spatial.layout_channel_names(layout))
        bound = back_half_bound(batch, n_in, wet.shape[-1], channels, eq_on)
        for loud in (1.0, 4.0):
            w = wet * loud if loud != 1.0 else wet
            eq = (lambda m: m) if eq_on else None
            key = label if loud == 1.0 else f"{label}_wet_x4"
            before = back_half_cuda.launch_count
            got = back_half_cuda.back_half(audio, w, scal, layout, RATE, eq)
            want = back_half_cuda.back_half_plain(audio, w, scal, layout, RATE, eq)
            torch.cuda.synchronize()
            check(back_half_cuda.launch_count == before + 1, f"{key}: not counted once")
            check(torch.equal(got, want), f"{key}: kernel and plain version differ")
            err = float((got - want).abs().max())
            fired = back_half_scales(torch, filters, spatial, audio, w, scal, layout, RATE,
                                     taken["eq"] if loud == 1.0 else eq)
            del got, want
            ms, plain_ms, runs = turns(
                torch, lambda: back_half_cuda.back_half(audio, w, scal, layout, RATE, eq),
                lambda: back_half_cuda.back_half_plain(audio, w, scal, layout, RATE, eq),
                kernel_iters=20, plain_iters=5)
            split = back_half_split(torch, lambda: back_half_cuda.back_half(
                audio, w, scal, layout, RATE, eq))
            result[key] = {
                "shape": [batch, 2, n_in, wet.shape[-1], channels], "layout": layout,
                "eq": eq_on, "equal": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "runs": runs,
                "split_ms": split, "fired": fired, **bound,
                "share_pct": 100.0 * bound["bound_ms"] / ms,
                "design_share_pct": 100.0 * bound["design_ms"] / ms,
            }
            print(f"[13 back half] {key}: {json.dumps(result[key])}", flush=True)
            del w
        del audio, wet, taken
        torch.cuda.empty_cache()
    return result


def metered_batch_phase(np, torch, sharding, loudness, bank, clips, device: str = "cuda") -> dict:
    """render_batch(with_metrics, clip_lengths, pcm16) at B × 60 s with mixed
    true lengths, EQ off and on; clips 0 and B − 1 against the CPU path, and
    their masked metrics against the meter on the trimmed output.  Each batch
    runs cold and again; the EQ-on batch also on B new true lengths in the
    same bucket, which must add no cuFFT plan (the length-dynamic EQ keys its
    plans on the bucket).  Then the EQ alone against its plain version
    (``eq_hold``)."""
    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.ops import filters

    batch, n_in = clips.shape[0], clips.shape[1]
    # the last ~20% of each clip cut by a different amount (clip 0 keeps all);
    # the second set cuts each a little less, so no length repeats
    lengths = [n_in - int(0.2 * n_in * b / (batch - 1)) for b in range(batch)]
    new_lengths = [n_in - 1 - int(0.19 * n_in * b / (batch - 1)) for b in range(batch)]
    check(not set(lengths) & set(new_lengths), "4c: the two sets of true lengths overlap")

    def padded_of(lens):
        padded = clips.copy()
        for b, tl in enumerate(lens):
            padded[b, tl:] = 0.0
        return padded

    pick = [0, batch - 1]
    on_card = torch.device(device).type == "cuda"
    timing = {}
    for label, p, fast in (
        ("eq off, fast", RenderParams(target_layout="Stereo"), True),
        ("eq on (bass 1.6, treble 0.7), exact",
         RenderParams(target_layout="Stereo", bass_gain=1.6, treble_gain=0.7), False),
    ):
        sets = [("cold", lengths), ("again", lengths)]
        if p.bass_gain != 1.0:
            sets.append(("new lengths", new_lengths))
        runs = {}
        for name, lens in sets:
            padded = padded_of(lens)
            state = card_state(torch, device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            before = bank.launch_count
            t0 = time.perf_counter()
            q, metrics = sharding.render_batch(padded, RATE, p, fast_filters=fast,
                                               with_metrics=True, clip_lengths=lens,
                                               pcm16_output=True, device=device)
            wall = time.perf_counter() - t0
            after = card_state(torch, device)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
            check(not on_card or bank.launch_count == before + 1,
                  f"{label} {name}: render_batch did not launch the bank once")
            check(q.dtype == np.int16 and q.shape[0] == batch and len(metrics) == batch,
                  f"{label} {name}: output {q.dtype} {q.shape}, {len(metrics)} metric dicts")
            runs[name] = {"wall_s": wall, "plans": [state["plans"], after["plans"]],
                          "free_gb": [state["free_gb"], after["free_gb"]], "peak_gb": peak_gb}
            print(f"[4c metered] {label}, {name}: render_batch {q.shape} {q.dtype} in "
                  f"{wall:.3f} s; cuFFT plans {state['plans']} -> {after['plans']}; free "
                  f"{state['free_gb']:.2f} -> {after['free_gb']:.2f} GB; peak allocated "
                  f"{peak_gb:.2f} GB; true lengths {min(lens)}..{max(lens)}", flush=True)
            if name == "cold":
                cold_q, cold_metrics = q, metrics
            del q, metrics, padded
        if "new lengths" in runs:
            added = runs["new lengths"]["plans"][1] - runs["new lengths"]["plans"][0]
            check(added == 0, f"{label}: {batch} new true lengths in the bucket added "
                              f"{added} cuFFT plans")
        timing[label] = runs
        q, metrics = cold_q, cold_metrics
        ref, ref_metrics = sharding.render_batch(
            padded_of(lengths)[pick], RATE, p, seeds=pick, fast_filters=fast, with_metrics=True,
            clip_lengths=[lengths[b] for b in pick], device="cpu",
        )
        ir_len = q.shape[1] - n_in + 1
        worst = [0.0, 0.0, 0.0, 0.0]
        for i, b in enumerate(pick):
            vlen = lengths[b] + ir_len - 1
            deq = q[b].astype(np.float32) / np.float32(32768.0)
            want = np.clip(ref[i], -0.9999, 0.9999)
            err = float(np.abs(deq - want).max())
            check(err <= RENDER_TOL + 0.5 / 32768, f"{label}: clip {b} card vs CPU {err}")
            check(not q[b, vlen:].any(), f"{label}: clip {b} not silent past its true span")
            d_cpu = check_metrics(metrics[b], ref_metrics[i], f"{label}: clip {b} card vs CPU")
            trimmed = loudness.audio_metrics(torch.from_numpy(deq[:vlen].T.copy())[None], RATE)
            d_trim = check_metrics(metrics[b], {k: float(v[0]) for k, v in trimmed.items()},
                                   f"{label}: clip {b} masked vs trimmed")
            worst = [max(worst[0], err), max(worst[1], d_cpu[0]), max(worst[2], d_trim[0]),
                     max(worst[3], d_trim[2])]
        lufs = [m["lufs"] for m in metrics]
        check(bool(np.isfinite(lufs).all()), f"{label}: non-finite LUFS")
        walls = ", ".join(f"{name} {r['wall_s']:.3f} s" for name, r in runs.items())
        print(f"[4c metered] {label}: {walls}; clips 0, {batch - 1}: card vs CPU max-abs "
              f"{worst[0]:.3e}, lufs d {worst[1]:.2e} LU; masked vs trimmed lufs d "
              f"{worst[2]:.2e} LU, rms d {worst[3]:.2e} dB", flush=True)
        del q, metrics, cold_q, cold_metrics
    timing["eq"] = eq_hold(np, torch, filters, [tl + ir_len - 1 for tl in lengths],
                           n_in + ir_len - 1, device)
    return timing


def run_cli(main, argv) -> tuple:
    """One CLI's ``main(argv)`` in this process → (its standard output, wall
    seconds); a non-zero exit fails the phase."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    check(rc == 0, f"{main.__module__} {argv[2:]}: exit {rc}")
    return buf.getvalue(), wall


def session_clips(np, rng):
    """24 seeded clips at 48 kHz, mono and stereo in turns: three length
    groups of 8 (about 30, 45 and 60 s), each inside one half-second bucket."""
    t_cache = {}
    clips = []
    for group, seconds in enumerate(STEM_SECONDS):
        bucket = seconds * RATE
        for k in range(8):
            n = bucket - 2400 * (k + 1) + int(rng.integers(0, 2400))
            if n not in t_cache:
                t_cache[n] = np.arange(n, dtype=np.float32) / RATE
            t = t_cache[n]
            f = 110.0 * (1 + group) + 23.0 * k
            x = (0.3 * np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t))
                 + rng.standard_normal(n, dtype=np.float32) * 0.02)
            clips.append(x[:, None] if k % 2 == 0 else np.stack([x, 0.8 * x[::-1]], axis=1))
    return clips


def cli_phase(np, torch, bank, work: str, device: str = "cuda") -> dict:
    """Phase 6: ``cli.render`` (plain, binaural, sweep), ``cli.render_dir``
    (metered, binaural) and ``cli.analyzer`` (analyze, normalize, convert)
    called in this process on the card, each result held to the port's own
    functions on the same inputs.  Returns the wall times, the binaural and
    resampler times and the bank launches the CLIs made."""
    from audio_raytracing_studio_tpu_torch import RenderParams, config
    from audio_raytracing_studio_tpu_torch.analysis.metrics import calculate_audio_metrics
    from audio_raytracing_studio_tpu_torch.cli import analyzer, render, render_dir
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import binaural, ir_synth
    from audio_raytracing_studio_tpu_torch.ops.resample import resample_poly
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.utils import wavio
    from audio_raytracing_studio_tpu_torch.utils.runtime import ensure_device

    dev = ensure_device(device)
    out = {"walls_s": {}, "launches": 0}
    path = lambda name: os.path.join(work, name)  # noqa: E731

    def pcm(name):
        data, rate = wavio.read(path(name))
        return np.rint(data * 32768.0).astype(np.int16), data, rate

    def cli(label, main, argv, launches):
        before = bank.launch_count
        stdout, wall = run_cli(main, [*argv, "--device", device])
        launched = bank.launch_count - before
        check(launched == launches, f"{label}: {launched} bank launches, expected {launches}")
        out["launches"] += launched
        out["walls_s"][label] = wall
        return stdout

    rng = np.random.default_rng(0x5E55)
    n = CLI_SECONDS * RATE
    t = np.arange(n, dtype=np.float32) / RATE
    song = np.stack([0.35 * np.sin(2 * np.pi * 220 * t) * np.exp(-(t % 2.0)),
                     0.3 * np.sin(2 * np.pi * 330 * t + 0.5) * np.exp(-((t + 1.0) % 2.0))],
                    axis=1) + rng.standard_normal((n, 2), dtype=np.float32) * 0.01
    wavio.write(path("song.wav"), song, RATE)
    audio, _ = wavio.read(path("song.wav"))
    layout = "5.1 (Standard)"
    flags = ["--hall", "Cathedral", "--room-size", "300", "--layout", layout, "--metrics",
             "--json", "--seed", "3"]
    p = RenderParams(hall_type="Cathedral", room_size=300.0, target_layout=layout)

    # --- one clip: plain (twice: the first call creates its cuFFT plans) ---
    res = json.loads(cli("render plain (first)", render.main,
                         [path("song.wav"), path("one.wav"), *flags], 1))
    res = json.loads(cli("render plain", render.main,
                         [path("song.wav"), path("one.wav"), *flags], 1))
    # the CLI's wall split: the WAV read, render() with its host copies, the write
    split = {}
    t0 = time.perf_counter()
    wavio.read(path("song.wav"))
    split["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, ref_m = pipeline.render(audio, RATE, p, seed=3, return_metrics=True, device=dev)
    split["render_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wavio.write_audio(path("again.wav"), np.clip(ref, -0.9999, 0.9999), RATE)
    split["clip_and_write_s"] = time.perf_counter() - t0
    out["render_plain_split"] = split
    q, one_data, _ = pcm("one.wav")
    check(q.shape == ref.shape and q.shape[1] == 6, f"render: {q.shape} vs {ref.shape}")
    check(np.array_equal(q, wavio.encode_pcm16(np.clip(ref, -0.9999, 0.9999))),
          "render: the written WAV differs from encode_pcm16 of render()")
    d = [abs(res[0]["metrics"][k] - ref_m[k]) for k in ("lufs", "true_peak_dbfs", "rms_dbfs")]
    check(max(d) <= 1e-6, f"render: JSON metrics {res[0]['metrics']} vs {ref_m}")
    # the card's render against the plain path on the CPU, and the bank at
    # this shape (Cathedral 300: 275,899 samples, B=1) against its plain version
    setup = pipeline.build_internal_setup(p, RATE, n)
    bank_errs = hold_bank(np, torch, bank, "cli render", setup.ir_shape, setup.ir_scalars, [3])
    cpu_ref = pipeline.render(audio, RATE, p, seed=3, device="cpu")
    render_err = float(np.abs(ref - cpu_ref).max())
    check(render_err <= RENDER_TOL, f"render: card vs CPU {render_err} > {RENDER_TOL}")
    del cpu_ref
    print(f"[6 cli] render {CLI_SECONDS} s, Cathedral 300, 5.1: {q.shape} int16 = encode_pcm16(render()) "
          f"bit for bit; render() card vs CPU {render_err:.3e}; bank B=1 length "
          f"{setup.ir_shape.length} kernel vs plain {max(bank_errs):.3e}; metrics d {max(d):.1e}; "
          f"wall {out['walls_s']['render plain']:.2f} s "
          f"(first call {out['walls_s']['render plain (first)']:.2f} s; read "
          f"{split['read_s']:.3f} s, render() {split['render_s']:.3f} s, clip and write "
          f"{split['clip_and_write_s']:.3f} s)", flush=True)

    # --- one clip, binaural ---
    res = json.loads(cli("render binaural", render.main,
                         [path("song.wav"), path("bin.wav"), *flags, "--binaural"], 1))
    q, bin_data, _ = pcm("bin.wav")
    card_bin = binaural.binauralize(ref, RATE, layout, device=dev)
    cpu_bin = binaural.binauralize(ref, RATE, layout, device="cpu")
    err = float(np.abs(card_bin - cpu_bin).max())
    check(q.shape == (ref.shape[0], 2), f"binaural: {q.shape}")
    check(err <= 1e-4, f"binaural: card vs CPU {err}")
    check(np.array_equal(q, wavio.encode_pcm16(np.clip(card_bin, -0.9999, 0.9999))),
          "binaural: the written WAV differs from the card's binauralize()")
    file_err = float(np.abs(bin_data - np.clip(cpu_bin, -0.9999, 0.9999)).max())
    check(file_err <= 1e-4, f"binaural: file vs CPU binauralize {file_err}")
    d_bin = check_metrics(res[0]["metrics"], calculate_audio_metrics(bin_data, RATE, device=dev),
                          "binaural: metrics vs the meter on the file")
    # the split: ear table built on the card, then the mix alone on resident data
    names = tuple(config.CHANNEL_LAYOUTS[layout]["names"])
    nfft = binaural.transform_size(names, ref.shape[0], RATE)
    binaural._binaural_table.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = binaural._binaural_table(names, RATE, nfft, str(dev))
    torch.cuda.synchronize()
    out["binaural_table_ms"] = 1e3 * (time.perf_counter() - t0)
    x_cn = torch.from_numpy(np.ascontiguousarray(ref.T)).to(dev)
    out["binaural_mix_ms"] = cuda_ms(torch, lambda: binaural._binaural_mix(
        x_cn, table, nfft, ref.shape[0]), 5)
    t0 = time.perf_counter()
    binaural.binauralize(ref, RATE, layout, device=dev)
    out["binauralize_call_ms"] = 1e3 * (time.perf_counter() - t0)
    out["binaural_nfft"] = nfft
    del x_cn, table
    print(f"[6 cli] render --binaural: {q.shape}; card vs CPU binauralize {err:.2e}, file vs "
          f"CPU {file_err:.2e}; metrics vs meter on the file lufs d {d_bin[0]:.1e} LU; wall "
          f"{out['walls_s']['render binaural']:.2f} s; binaural at {CLI_SECONDS} s of 5.1 (nfft {nfft}): "
          f"table {out['binaural_table_ms']:.2f} ms, mix {out['binaural_mix_ms']:.2f} ms, "
          f"binauralize() with host copies {out['binauralize_call_ms']:.2f} ms", flush=True)

    # --- a sweep ---
    values = [0.2, 0.5, 0.8]
    cli("render sweep", render.main,
        [path("song.wav"), path("sw_{i}.wav"), *flags, "--sweep", "diffusion=0.2,0.5,0.8"], 1)
    outs, _ = sharding.render_batch(
        np.stack([audio] * 3), RATE, [dataclasses.replace(p, diffusion=v) for v in values],
        seeds=[3] * 3, with_metrics=True, device=dev)
    for i in range(3):
        check(np.array_equal(pcm(f"sw_{i}.wav")[0],
                             wavio.encode_pcm16(np.clip(outs[i], -0.9999, 0.9999))),
              f"sweep: file {i} differs from render_batch row {i}")
    del outs
    sweep = [pipeline.build_internal_setup(dataclasses.replace(p, diffusion=v), RATE, n)
             for v in values]
    check(all(s.ir_shape == setup.ir_shape for s in sweep), "sweep: the IR shape changed")
    errs = hold_bank(np, torch, bank, "cli sweep", setup.ir_shape,
                     ir_synth.IRScalars.stack([s.ir_scalars for s in sweep]), [3] * 3)
    bank_errs = [max(a, b) for a, b in zip(bank_errs, errs)]
    print(f"[6 cli] render --sweep diffusion=0.2,0.5,0.8: 3 files = render_batch rows bit for "
          f"bit; bank B=3 kernel vs plain {max(errs):.3e}; wall "
          f"{out['walls_s']['render sweep']:.2f} s", flush=True)

    # --- a directory: 24 clips (a session's stems) through one hall ---
    os.makedirs(path("stems"))
    os.makedirs(path("stems8"))
    clips = session_clips(np, rng)
    for i, c in enumerate(clips):
        wavio.write(path(f"stems/stem{i:02d}.wav"), c, RATE)
        if 8 <= i < 16:
            os.link(path(f"stems/stem{i:02d}.wav"), path(f"stems8/stem{i:02d}.wav"))
    true_len = {f"stem{i:02d}.wav": c.shape[0] for i, c in enumerate(clips)}
    audio_s = sum(true_len.values()) / RATE
    del clips
    ir_len = pipeline.build_internal_spec(RenderParams(), RATE, RATE)[0].ir_length
    for label, src, extra, channels, launches in (
        ("render_dir", "stems", [], 6, 3),
        ("render_dir binaural", "stems8", ["--binaural", "--layout", layout], 2, 1),
    ):
        res = json.loads(cli(label, render_dir.main,
                             [path(src), path(src + "_out"), "--batch", "8", "--metrics",
                              "--json", *extra], launches))
        check(len(res["clips"]) == len(os.listdir(path(src))), f"{label}: {len(res['clips'])} clips")
        worst = [0.0, 0.0, 0.0]
        for clip in res["clips"]:
            name = os.path.basename(clip["output"])
            data, rate = wavio.read(clip["output"])
            check(data.shape == (true_len[name] + ir_len - 1, channels),
                  f"{label}: {name} {data.shape}, expected ({true_len[name]} + {ir_len} - 1, "
                  f"{channels})")
            d = check_metrics(clip["metrics"], calculate_audio_metrics(data, rate, device=dev),
                              f"{label}: {name} metrics vs the meter on the file")
            worst = [max(a, b) for a, b in zip(worst, d)]
        out[f"{label} realtime_factor"] = res["realtime_factor"]
        print(f"[6 cli] {label} --batch 8 --metrics: {len(res['clips'])} clips, "
              f"{res['audio_seconds']:.1f} audio-s in {res['wall_seconds']:.2f} s = "
              f"{res['realtime_factor']:.1f}x realtime (file I/O included); lengths = true + "
              f"IR - 1; metrics vs the meter on the files: lufs d {worst[0]:.1e} LU, peak d "
              f"{worst[1]:.1e} dB, rms d {worst[2]:.1e} dB", flush=True)
    out["render_dir_audio_s"] = audio_s
    # the bank at render_dir's shape and seeds: default hall, micro-batches
    # of 8 with seeds 0-7, 8-15 and 16-23 (the binaural run's 8 stems: 0-7)
    dir_setup = pipeline.build_internal_setup(RenderParams(), RATE, RATE)
    for base in (0, 8, 16):
        errs = hold_bank(np, torch, bank, f"cli render_dir seeds {base}-{base + 7}",
                         dir_setup.ir_shape, dir_setup.ir_scalars, range(base, base + 8))
        bank_errs = [max(a, b) for a, b in zip(bank_errs, errs)]
    out["bank_max_abs_err"] = max(bank_errs)
    print(f"[6 cli] bank at the CLI shapes (B=1, B=3 x {setup.ir_shape.length}; B=8 x "
          f"{dir_setup.ir_shape.length}): kernel vs plain max-abs early {bank_errs[0]:.3e} "
          f"late {bank_errs[1]:.3e} (tol {BANK_TOL})", flush=True)

    # --- the analyzer ---
    res = json.loads(cli("analyze --true-peak", analyzer.main,
                         ["analyze", path("one.wav"), "--true-peak"], 0))
    check(res["Kanäle"] == 6 and abs(res["LUFS"] - ref_m["lufs"]) <= 0.01
          and np.isfinite(res["True Peak 4x (dBTP)"]) and res["True Peak 4x (dBTP)"] >= res["Peak (dBFS)"] - 0.01,
          f"analyze: {res}")
    res_n = json.loads(cli("normalize --target -16", analyzer.main,
                           ["normalize", path("one.wav"), path("norm.wav"), "--target", "-16"], 0))
    lufs_n = calculate_audio_metrics(wavio.read(path("norm.wav"))[0], RATE, device=dev)["lufs"]
    check(abs(lufs_n + 16.0) <= 0.05, f"normalize: {lufs_n} LUFS measured again, {res_n}")
    t44 = np.arange(CLI_SECONDS * 44100, dtype=np.float32) / 44100
    at44 = (np.stack([0.4 * np.sin(2 * np.pi * 997 * t44), 0.3 * np.sin(2 * np.pi * 15000 * t44)],
                     axis=1) + rng.standard_normal((t44.size, 2), dtype=np.float32) * 0.02)
    wavio.write(path("at44k1.wav"), at44, 44100)
    cli("convert --samplerate 48000", analyzer.main,
        ["convert", path("at44k1.wav"), path("at48k.wav"), "--samplerate", "48000"], 0)
    x44 = torch.from_numpy(wavio.read(path("at44k1.wav"))[0]).to(dev)
    # with the caller's TF32 on: resample_poly turns it off for its conv alone
    torch.backends.cudnn.allow_tf32 = True
    card_rs = resample_poly(x44, 48000, 44100)
    check(torch.backends.cudnn.allow_tf32, "resample_poly left the caller's cuDNN TF32 changed")
    torch.backends.cudnn.allow_tf32 = False
    cpu_rs = resample_poly(x44.cpu(), 48000, 44100)
    rs_err = float((card_rs.cpu() - cpu_rs).abs().max())
    check(rs_err <= 1e-5, f"resample_poly: card vs CPU {rs_err}")
    q48, _, rate48 = pcm("at48k.wav")
    check(rate48 == 48000 and q48.shape == (CLI_SECONDS * 48000, 2),
          f"convert: {q48.shape} at {rate48}")
    check(np.array_equal(q48, wavio.encode_pcm16(card_rs.cpu().numpy())),
          "convert: the written WAV differs from resample_poly on the card")
    out["resample_poly_ms"] = cuda_ms(torch, lambda: resample_poly(x44, 48000, 44100), 10)
    w = out["walls_s"]
    print(f"[6 cli] analyze --true-peak: LUFS {res['LUFS']}, peak {res['Peak (dBFS)']} dBFS, "
          f"true peak {res['True Peak 4x (dBTP)']} dBTP ({w['analyze --true-peak']:.2f} s); "
          f"normalize --target -16 measured again at {lufs_n:.4f} LUFS "
          f"({w['normalize --target -16']:.2f} s); convert {CLI_SECONDS} s stereo 44.1 -> 48 kHz "
          f"({w['convert --samplerate 48000']:.2f} s): card vs CPU resample_poly {rs_err:.2e}, "
          f"file = encode_pcm16(card result); resample_poly on the card "
          f"{out['resample_poly_ms']:.2f} ms", flush=True)
    return out


def wait_all(futures, timeout: float = 300.0) -> list:
    """Every future's result; a stuck worker ends the run with a timeout
    error instead of a hang."""
    return [f.result(timeout=timeout) for f in futures]


def busy_share(torch, fn) -> dict:
    """``fn`` under torch.profiler → the share of its wall during which at
    least one kernel or copy ran on the card (the union of the device
    events' intervals over the host wall of ``fn``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(bool(spans), "the profiler saw no device events in the burst")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy = (busy + (hi - lo)) / 1e6  # microseconds → seconds
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
            "device_events": len(spans)}


def outside_allocator(torch) -> int:
    """Bytes in use on the card beside PyTorch's caching allocator (the cuFFT
    plans' own tables, the context)."""
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def max_abs(np, torch, a, b) -> float:
    """max |a − b| of two equal-shaped host arrays, a slice at a time (no
    clip-sized temporaries), on the host's threads."""
    check(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    ta = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    tb = torch.from_numpy(np.ascontiguousarray(b).reshape(-1))
    step = 1 << 25
    worst = 0.0
    for s in range(0, ta.numel(), step):
        d = (ta[s:s + step].double() - tb[s:s + step].double()).abs().max().item()
        check(d == d, "a NaN in a compared result")
        worst = max(worst, d)
    return worst


def http_call(port: int, method: str, path: str, body=None, headers=None):
    """One request to the service on 127.0.0.1 → (status code, body bytes);
    an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serving_phase(np, torch, bank, work: str, clips, device: str = "cuda") -> dict:
    """Phase 7: the serving path.  7a a burst of one job per row of
    ``clips`` through ``RenderService`` (fast and exact filters, pipeline
    depth 1 and 2), 7b mixed traffic from 8 threads, 7c the HTTP job API —
    each result held to the port's own direct calls on the same device, the
    bank to its plain version at every batch size the service dispatches.
    Returns the timings, the counted bank launches of the service's own
    dispatches and the bank's worst error."""
    import socket
    import threading

    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import ir_synth
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService
    from audio_raytracing_studio_tpu_torch.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu_torch.utils import wavio
    from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore
    from audio_raytracing_studio_tpu_torch.utils.runtime import ensure_device

    dev = ensure_device(device)
    on_card = dev.type == "cuda"
    batch, n_full = clips.shape
    seconds = n_full / RATE
    out = {"launches": 0, "bank_errs": [0.0, 0.0]}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def served(fn):
        """Run ``fn`` (service traffic only) and count its bank launches."""
        before = bank.launch_count
        result = fn()
        out["launches"] += bank.launch_count - before
        return result

    def drain(futures):
        """Wait for every future in turn and keep no result."""
        while futures:
            futures.pop(0).result(timeout=300)

    def hold(label, shape, scalars, seeds):
        errs = hold_bank(np, torch, bank, label, shape, scalars, seeds)
        out["bank_errs"] = [max(a, b) for a, b in zip(out["bank_errs"], errs)]

    # ---------------- 7a: a burst of `batch` jobs ----------------
    # value parameters swept per job, one shape for all; true lengths differ
    # inside one half-second bucket, so every job is padded and trimmed
    params = [RenderParams(target_layout="Stereo", diffusion=0.2 + 0.6 * i / (batch - 1),
                           air_absorption=0.1 + 0.8 * i / (batch - 1),
                           dry_wet=0.3 + 0.5 * ((7 * i) % batch) / (batch - 1),
                           x_pos=i / (batch - 1), y_pos=((5 * i) % batch) / (batch - 1))
              for i in range(batch)]
    lengths = [n_full - 97 * i for i in range(batch)]
    seeds = [1000 + 13 * i for i in range(batch)]
    n_bucket = sharding.bucket_length(n_full, RATE)
    check(all(sharding.bucket_length(n, RATE) == n_bucket for n in lengths),
          "7a: the clips do not share one length bucket")
    padded = np.zeros((batch, n_bucket), np.float32)
    for i, n in enumerate(lengths):
        padded[i, :n] = clips[i, :n]

    def burst_jobs(offset=0):
        return [RenderJob(clips[i, :lengths[i]], RATE, params[i], seed=seeds[i] + offset,
                          with_metrics=True) for i in range(batch)]

    setups = [pipeline.build_internal_setup(p, RATE, n_bucket) for p in params]
    shape = setups[0].ir_shape
    check(all(s.ir_shape == shape for s in setups), "7a: the sweep changed the IR shape")
    ir_tail = shape.length - 1
    rounds = 4  # the sustained run: this many bursts back to back
    timing = {}
    first = {}
    for fast in (True, False):
        mode = "fast" if fast else "exact"
        t0 = time.perf_counter()
        direct_q, direct_m = sharding.render_batch(
            padded, RATE, params, seeds=seeds, fast_filters=fast, with_metrics=True,
            clip_lengths=lengths, pcm16_output=True, device=dev)
        timing[f"direct_{mode}_s"] = time.perf_counter() - t0
        for depth in (1, 2):
            # max_wait_ms: long enough that a burst submitted from one thread
            # forms one group, whatever the host's speed
            svc = RenderService(max_batch=batch, max_wait_ms=2000, pcm16_output=True,
                                fast_filters=fast, pipeline_depth=depth,
                                max_queued=rounds * batch, device=dev)
            try:
                for _ in range(depth):  # one warm burst per stream of the service
                    served(lambda: wait_all([svc.submit(j) for j in burst_jobs()]))
                sync()
                t0 = time.perf_counter()
                futs = [svc.submit(j) for j in burst_jobs()]
                submit_s = time.perf_counter() - t0
                results = served(lambda: wait_all(futs))
                wall = time.perf_counter() - t0
                del futs
                st = svc.stats()
                check(st["batch_sizes"] == [batch] * (depth + 1) and st["jobs_failed"] == 0,
                      f"7a {mode} depth {depth}: batches {st['batch_sizes']}, "
                      f"{st['jobs_failed']} failed")
                for i, r in enumerate(results):
                    real = lengths[i] + ir_tail
                    check(r.audio.dtype == np.int16 and r.audio.shape == (real, 2),
                          f"7a {mode} depth {depth}: job {i} {r.audio.dtype} {r.audio.shape}")
                    check(np.array_equal(r.audio, direct_q[i, :real]),
                          f"7a {mode} depth {depth}: job {i} differs from the direct "
                          "render_batch row")
                    check(r.metrics == direct_m[i],
                          f"7a {mode} depth {depth}: job {i} metrics {r.metrics} vs "
                          f"{direct_m[i]}")
                    check(not direct_q[i, real:].any(), f"7a {mode}: row {i} not silent past its span")
                if depth == 1:
                    first[mode] = results
                else:
                    for i, (a, b) in enumerate(zip(first[mode], results)):
                        check(np.array_equal(a.audio, b.audio) and a.metrics == b.metrics,
                              f"7a {mode}: job {i} at depth 2 differs from depth 1")
                del results
                # sustained: `rounds` bursts queued at once, results dropped as they
                # come; twice, since the first run still meets new staging buffers
                for attempt in ("sustained_first_wall_s", "sustained_wall_s"):
                    before = svc.stats()
                    sync()
                    t0 = time.perf_counter()
                    served(lambda: drain([svc.submit(j) for k in range(rounds)
                                          for j in burst_jobs(offset=k)]))
                    timing.setdefault(f"{mode}_depth{depth}", {})[attempt] = (
                        time.perf_counter() - t0)
                sustained = timing[f"{mode}_depth{depth}"]["sustained_wall_s"]
                after = svc.stats()
                check(after["jobs_failed"] == 0
                      and after["batch_sizes"] == [batch] * (2 * rounds + depth + 1),
                      f"7a {mode} depth {depth}: batches {after['batch_sizes']}, "
                      f"{after['jobs_failed']} failed")
                n_groups = after["batches"] - before["batches"]
                timing[f"{mode}_depth{depth}"].update({
                    "burst_wall_s": wall,
                    "burst_submit_s": submit_s,
                    "burst_audio_s_per_s": sum(lengths) / RATE / wall,
                    "sustained_jobs": rounds * batch,
                    "sustained_groups": n_groups,
                    "sustained_wall_s": sustained,
                    "sustained_audio_s_per_s": rounds * sum(lengths) / RATE / sustained,
                    "dispatch_s_per_group": (after["dispatch_s"] - before["dispatch_s"]) / n_groups,
                    "fetch_s_per_group": (after["fetch_s"] - before["fetch_s"]) / n_groups,
                })
                if on_card and depth == 2 and fast:
                    timing["busy_fast_depth2"] = busy_share(torch, lambda: served(
                        lambda: drain([svc.submit(j) for k in range(2)
                                       for j in burst_jobs(offset=k)])))
                check(svc.stats()["inflight_input_bytes"] == 0, "7a: in-flight bytes left")
            finally:
                svc.stop()
            print(f"[7a burst] {mode} depth {depth}: {batch} jobs x {seconds:.0f} s = direct "
                  f"render_batch rows bit for bit (PCM16, metrics equal)"
                  f"{', = depth 1' if depth == 2 else ''}; burst {wall:.3f} s, sustained "
                  f"{rounds}x{batch} jobs {sustained:.3f} s", flush=True)
        del direct_q
        if on_card:
            torch.cuda.empty_cache()
    del first

    # one float32 burst against the port's CPU path on the first and last job
    svc = RenderService(max_batch=batch, max_wait_ms=2000, fast_filters=False,
                        max_queued=batch, device=dev)
    try:
        results = served(lambda: wait_all([svc.submit(j) for j in burst_jobs()]))
    finally:
        svc.stop()
    pick = [0, batch - 1]
    ref = sharding.render_batch(padded[pick], RATE, [params[i] for i in pick],
                                seeds=[seeds[i] for i in pick],
                                clip_lengths=[lengths[i] for i in pick], device="cpu")
    cpu_err = max(float(np.abs(results[i].audio - ref[k, :lengths[i] + ir_tail]).max())
                  for k, i in enumerate(pick))
    check(results[0].audio.dtype == np.float32 and cpu_err <= RENDER_TOL,
          f"7a float32 burst vs the CPU path: {cpu_err} > {RENDER_TOL}")
    del results, ref
    print(f"[7a burst] float32 exact burst: jobs 0 and {batch - 1} vs the port's CPU path "
          f"max-abs {cpu_err:.3e} (tol {RENDER_TOL})", flush=True)

    # warm() while a burst is in flight: it renders on the worker's streams
    # from this thread, so the live bursts must still equal the direct rows
    direct_q, direct_m = sharding.render_batch(
        padded, RATE, params, seeds=seeds, fast_filters=True, with_metrics=True,
        clip_lengths=lengths, pcm16_output=True, device=dev)
    svc = RenderService(max_batch=batch, max_wait_ms=2000, pcm16_output=True, fast_filters=True,
                        pipeline_depth=2, max_queued=2 * batch, device=dev)
    overlapped = 0
    warm_rounds = 3
    try:
        for _ in range(2):  # one burst per stream first
            served(lambda: wait_all([svc.submit(j) for j in burst_jobs()]))
        t0 = time.perf_counter()
        for _ in range(warm_rounds):
            futs = [svc.submit(j) for _ in range(2) for j in burst_jobs()]
            warmed = served(lambda: svc.warm(burst_jobs()[0], sizes=[batch]))
            overlapped += sum(not f.done() for f in futs) > 0  # jobs still out when warm ended
            results = served(lambda: wait_all(futs))
            for k, r in enumerate(results):
                i = k % batch
                check(np.array_equal(r.audio, direct_q[i, :lengths[i] + ir_tail])
                      and r.metrics == direct_m[i],
                      f"7a warm: job {i} of a burst that overlapped warm() differs from "
                      "the direct render_batch row")
            del futs, results
        timing["warm_overlap"] = {"rounds": warm_rounds, "rounds_with_jobs_still_out": overlapped,
                                  "buckets_warmed": warmed, "streams": len(svc._streams),
                                  "wall_s": time.perf_counter() - t0}
        check(svc.stats()["jobs_failed"] == 0, "7a warm: a job failed")
    finally:
        svc.stop()
    del direct_q
    print(f"[7a warm] warm(sizes=[{batch}]) on both streams from the calling thread while two "
          f"bursts of {batch} were queued or in flight, {warm_rounds} times ({overlapped} with "
          f"jobs still out when warm() returned): every job = its direct render_batch row "
          f"bit for bit", flush=True)

    if on_card:
        # the bank at every batch size the service dispatches at, 7a's scalars
        svc = RenderService(max_batch=batch, device=dev, start=False)
        sizes = svc.bucket_sizes()
        svc.stop()
        for b in sizes:
            hold(f"serving B={b}", shape,
                 ir_synth.IRScalars.stack([s.ir_scalars for s in setups[:b]]), seeds[:b])
        print(f"[7 bank] B in {sizes} x {shape.length}: kernel vs plain max-abs early "
              f"{out['bank_errs'][0]:.3e} late {out['bank_errs'][1]:.3e} (tol {BANK_TOL})",
              flush=True)

        # async_results: the call returns before the card is done (the second
        # of two calls: the first meets a new staging buffer)
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fetch = sharding.render_batch(padded, RATE, params, seeds=seeds, with_metrics=True,
                                          clip_lengths=lengths, pcm16_output=True,
                                          async_results=True, device=dev)
            timing["async_return_s"] = time.perf_counter() - t0
            fetch()
            timing["async_fetch_done_s"] = time.perf_counter() - t0
            del fetch
        # one group's copies by CUDA events around the copy alone: page-locked
        # and asynchronous (the port's path) against pageable and blocking;
        # and the host's share of staging (filling the page-locked buffer)
        stereo = np.repeat(padded[:, :, None], 2, axis=2)
        res = torch.zeros((batch, n_bucket + ir_tail, 2), dtype=torch.int16, device=dev)
        up_pinned = torch.from_numpy(sharding.staging_clips(batch, n_bucket, 2, dev))
        down_pinned = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)

        def timed(fn):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            sync()
            t0 = time.perf_counter()
            start.record()
            keep = fn()
            stop.record()
            returned = time.perf_counter() - t0
            sync()
            del keep
            return {"device_ms": start.elapsed_time(stop), "returned_after_ms": 1e3 * returned}

        t0 = time.perf_counter()
        up_pinned.copy_(torch.from_numpy(stereo))
        timing["stage_host_copy_ms"] = 1e3 * (time.perf_counter() - t0)
        for label, fn in (
            ("upload_pinned", lambda: up_pinned.to(dev, non_blocking=True)),
            ("upload_pageable", lambda: torch.from_numpy(stereo).to(dev)),
            ("download_pinned", lambda: down_pinned.copy_(res, non_blocking=True)),
            ("download_pageable", lambda: res.cpu()),
        ):
            fn()
            timing[label] = timed(fn)
        timing["upload_mb"] = stereo.nbytes / 1e6
        timing["download_mb"] = res.numel() * 2 / 1e6
        del stereo, res, up_pinned, down_pinned
        torch.cuda.empty_cache()

    # ---------------- 7b: mixed traffic from 8 threads ----------------
    rng = np.random.default_rng(0x7B)
    cathedral = dict(hall_type="Cathedral", room_size=300.0)
    eq = dict(bass_gain=1.6, treble_gain=0.7)
    ir = (rng.standard_normal((int(0.4 * RATE), 2))
          * np.exp(-np.arange(int(0.4 * RATE)) / (0.05 * RATE))[:, None] * 0.3).astype(np.float32)
    # (count, base params, metrics, seconds as a share of the clip, with EQ every k-th job)
    families = [
        (16, dict(target_layout="Stereo"), True, 1.0, 4),
        (8, dict(target_layout="5.1 (Standard)"), False, 0.755, 0),
        (12, dict(target_layout="Stereo", **cathedral), True, 0.34, 6),
        (8, dict(target_layout="5.1 (Standard)", **cathedral), True, 0.53, 0),
        (8, dict(target_layout="Stereo", use_external_ir=True), True, 0.53, 0),
        (12, dict(target_layout="Stereo"), False, 0.34, 0),
    ]
    jobs = []
    for f, (count, base, metered, share, eq_every) in enumerate(families):
        bucket = sharding.bucket_length(int(share * n_full), RATE)
        for k in range(count):
            n = bucket - (0 if k == 0 else int(rng.integers(1, max(2, RATE // 4))))
            p = RenderParams(diffusion=0.3 + 0.05 * (k % 8), x_pos=(k % 5) / 4.0,
                             **(eq if eq_every and k % eq_every == 1 else {}), **base)
            jobs.append(RenderJob(clips[(f + k) % batch, :n], RATE, p, seed=100 * f + k,
                                  with_metrics=metered,
                                  external_ir=ir if p.use_external_ir else None))
    order = rng.permutation(len(jobs))

    if on_card:
        # 7b's own plans and memory: start from an empty plan cache
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        outside_before = outside_allocator(torch)
        pinned_before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    svc = RenderService(max_batch=16, max_wait_ms=100, max_queued=len(jobs), device=dev)
    try:
        keys = {svc._prepare(j).key for j in jobs}
        buckets = {k[1].n_in if k[0] == "internal" else k[2] for k in keys}
        check(len(buckets) >= 3, f"7b: only {len(buckets)} length buckets")
        futures = [None] * len(jobs)
        submitted = [0.0] * len(jobs)
        done = [0.0] * len(jobs)

        def client(mine):
            for j in mine:
                submitted[j] = time.monotonic()
                futures[j] = svc.submit(jobs[j])
                futures[j].add_done_callback(
                    lambda _f, j=j: done.__setitem__(j, time.monotonic()))

        def traffic():
            threads = [threading.Thread(target=client, args=(order[t::8],)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                check(not t.is_alive(), "7b: a client thread is stuck")
            return wait_all(futures)

        t0 = time.perf_counter()
        results = served(traffic)
        wall = time.perf_counter() - t0
        st = svc.stats()
        lat = sorted(d - s for d, s in zip(done, submitted))
        # the same traffic again: every cuFFT plan and allocator block is there now
        t0 = time.perf_counter()
        served(traffic)
        warm_wall = time.perf_counter() - t0
        warm_lat = sorted(d - s for d, s in zip(done, submitted))
        warm_st = svc.stats()
        check(warm_st["jobs_done"] == 2 * len(jobs) and warm_st["jobs_failed"] == 0,
              f"7b: second pass {warm_st['jobs_done']} done, {warm_st['jobs_failed']} failed")
        check(sum(st["batch_sizes"]) == len(jobs) and st["jobs_failed"] == 0
              and len(keys) <= st["batches"] and max(st["batch_sizes"]) <= 16,
              f"7b: batches {st['batch_sizes']} for {len(keys)} keys")
        # refused at submit: a mono external IR, an empty clip, a clip past the threshold
        for bad, word in (
            (RenderJob(clips[0, :n_full // 8], RATE, RenderParams(use_external_ir=True),
                       external_ir=ir[:, :1]), "stereo"),
            (RenderJob(np.zeros(0, np.float32), RATE, RenderParams()), "audio"),
        ):
            try:
                svc.submit(bad)
                check(False, f"7b: a bad job ({word}) was accepted")
            except ValueError as e:
                check(word in str(e).lower(), f"7b: refusal says {e}")
        check(svc.stats()["inflight_input_bytes"] == 0, "7b: in-flight bytes left")
    finally:
        svc.stop()
    short = RenderService(max_batch=4, streaming_threshold_s=seconds / 4, device=dev,
                          start=False)
    try:
        short.warm(RenderJob(clips[0], RATE, RenderParams()))
        check(False, "7b: warm() took a job past streaming_threshold_s")
    except ValueError as e:
        check("streaming" in str(e), f"7b: refusal says {e}")
    # a cancelled queued job gives its bytes back
    fut = short.submit(RenderJob(clips[0, :n_full // 8], RATE, RenderParams()))
    check(short.stats()["inflight_input_bytes"] > 0 and fut.cancel(), "7b: cancel failed")
    short.start()
    short.stop()
    check(short.stats()["inflight_input_bytes"] == 0 and short.stats()["batches"] == 0,
          "7b: the cancelled job kept its bytes or was dispatched")
    mixed = {"wall_s": wall, "jobs": len(jobs), "keys": len(keys), "batches": st["batches"],
             "batch_sizes": st["batch_sizes"],
             "audio_s_per_s": sum(j.audio.shape[0] for j in jobs) / RATE / wall,
             "dispatch_s": st["dispatch_s"], "fetch_s": st["fetch_s"],
             "fft_plans": st["fft_plans"], "fft_plans_max": st["fft_plans_max"],
             "pinned_mb": st["pinned_mb"], "device_reserved_mb": st["device_reserved_mb"],
             "uploaded_mb": st["dispatched_input_bytes_total"] / 1e6,
             "fetched_mb": st["fetched_result_bytes_total"] / 1e6}
    mixed["latency_p50_s"] = lat[len(lat) // 2]
    mixed["latency_p95_s"] = lat[int(0.95 * (len(lat) - 1))]
    mixed["warm"] = {
        "wall_s": warm_wall,
        "audio_s_per_s": sum(j.audio.shape[0] for j in jobs) / RATE / warm_wall,
        "batch_sizes": warm_st["batch_sizes"][st["batches"]:],
        "dispatch_s": warm_st["dispatch_s"] - st["dispatch_s"],
        "fetch_s": warm_st["fetch_s"] - st["fetch_s"],
        "latency_p50_s": warm_lat[len(warm_lat) // 2],
        "latency_p95_s": warm_lat[int(0.95 * (len(warm_lat) - 1))],
        "fft_plans": warm_st["fft_plans"],
    }
    if on_card:
        mixed["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # what the card holds beside PyTorch's allocator: the cuFFT plans' tables
        mixed["outside_allocator_mb"] = outside_allocator(torch) / 1e6
        mixed["outside_allocator_before_mb"] = outside_before / 1e6
        mixed["pinned_before_mb"] = pinned_before / 1e6
    # every job against its solo render on the same device
    worst = [0.0, 0, 0.0]
    for j, (job, r) in enumerate(zip(jobs, results)):
        solo, solo_m = pipeline.render(job.audio, RATE, job.params, seed=job.seed,
                                       external_ir=job.external_ir, return_metrics=True,
                                       device=dev)
        check(r.audio.shape == solo.shape, f"7b: job {j} {r.audio.shape} vs solo {solo.shape}")
        err = float(np.abs(r.audio - solo).max())
        clip16 = lambda x: wavio.encode_pcm16(np.clip(x, -0.9999, 0.9999)).astype(np.int32)  # noqa: E731
        lsb = int(np.abs(clip16(r.audio) - clip16(solo)).max())
        check(err <= SERVE_TOL and lsb <= 1,
              f"7b: job {j} ({job.params}) vs its solo render: {err} max-abs, {lsb} LSB")
        worst[:2] = [max(worst[0], err), max(worst[1], lsb)]
        check((r.metrics is not None) == job.with_metrics, f"7b: job {j} metrics presence")
        if job.with_metrics:
            worst[2] = max(worst[2], check_metrics(r.metrics, solo_m, f"7b: job {j}")[0])
    del results
    mixed.update(solo_max_abs=worst[0], solo_lsb=worst[1], solo_lufs_d=worst[2])
    timing["mixed"] = mixed
    print(f"[7b mixed] {len(jobs)} jobs from 8 threads, {len(keys)} keys in {len(buckets)} "
          f"length buckets -> batches {st['batch_sizes']}; each vs its solo render: max-abs "
          f"{worst[0]:.3e} (tol {SERVE_TOL}), PCM16 {worst[1]} LSB, lufs d {worst[2]:.2e} LU; "
          f"refused at submit: mono IR, empty clip; warm() refuses a clip past "
          f"streaming_threshold_s; the "
          f"cancelled job gave its bytes back; wall {wall:.2f} s cold (new cuFFT plans), "
          f"{warm_wall:.2f} s again", flush=True)
    if on_card:
        # the bank at 7b's padded Cathedral groups (12 jobs pad to 16, 8 stay 8)
        cat = pipeline.build_internal_setup(RenderParams(**cathedral), RATE, RATE)
        for b in (8, 16):
            hold(f"serving cathedral B={b}", cat.ir_shape, cat.ir_scalars, range(200, 200 + b))
        print(f"[7 bank] Cathedral 300, B in (8, 16) x {cat.ir_shape.length}: kernel vs plain "
              f"max-abs early {out['bank_errs'][0]:.3e} late {out['bank_errs'][1]:.3e}",
              flush=True)
        # a bucket nobody has rendered yet against the same bucket again
        svc = RenderService(max_batch=8, device=dev, start=False)
        job = RenderJob(clips[1, :int(0.61 * n_full)], RATE,
                        RenderParams(target_layout="7.1 (Surround)"), with_metrics=True)
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            svc.warm(job, sizes=[8])
            timing[f"bucket_{label}_s"] = time.perf_counter() - t0
        svc.stop()
        torch.cuda.empty_cache()

    # ---------------- 7c: the HTTP job API ----------------
    n_http = n_full - RATE // 3  # off the half-second grid: padded and trimmed
    PresetStore(work).save("Smoke Hall", RenderParams(target_layout="Stereo", diffusion=0.7,
                                                      **cathedral))
    svc = RenderService(max_batch=4, max_wait_ms=50, pcm16_output=True, device=dev, start=False)
    http = RenderHTTPService(svc, host="127.0.0.1", port=0, preset_dir=work).start()
    try:
        def upload(name, data, rate=RATE):
            buf = io.BytesIO()
            wavio.write(buf, data, rate)
            code, body = http_call(http.port, "POST", "/v1/upload", buf.getvalue(),
                                   {"X-Filename": name})
            check(code == 200, f"7c: upload {name} answered {code}")
            return json.loads(body)["path"]

        def post_job(payload, expect=202):
            code, body = http_call(http.port, "POST", "/v1/jobs", json.dumps(payload).encode())
            check(code == expect, f"7c: POST /v1/jobs {payload} answered {code}: {body[:200]}")
            return json.loads(body)

        t0 = time.perf_counter()
        paths = [upload(f"clip{i}.wav", clips[i, :n_http]) for i in range(4)]
        ir_path = upload("ir.wav", ir)
        upload_s = time.perf_counter() - t0
        plain = dict(target_layout="Stereo", diffusion=0.4)
        submitted_jobs = [
            (post_job({"input": paths[0], "params": plain, "seed": 5, "metrics": True}),
             paths[0], RenderParams(**plain), 5, False),
            (post_job({"input": paths[1], "preset": "Smoke_Hall_v4.json",
                       "params": {"x_pos": 0.9}, "seed": 6}),
             paths[1], RenderParams(target_layout="Stereo", diffusion=0.7, x_pos=0.9,
                                    **cathedral), 6, False),
            (post_job({"input": paths[2], "params": {"use_external_ir": True,
                                                     "target_layout": "Stereo"},
                       "external_ir": ir_path, "seed": 7}),
             paths[2], RenderParams(use_external_ir=True, target_layout="Stereo"), 7, True),
        ]
        doomed = post_job({"input": paths[3], "params": plain})["job_id"]
        # the error contracts, while every job is still queued
        first_id = submitted_jobs[0][0]["job_id"]
        check(http_call(http.port, "GET", f"/v1/jobs/{first_id}/result")[0] == 409,
              "7c: the result of a queued job did not answer 409")
        code, body = http_call(http.port, "DELETE", f"/v1/jobs/{doomed}")
        check(code == 200 and json.loads(body)["cancelled"] is True, f"7c: DELETE answered {code}")
        check(http_call(http.port, "GET", f"/v1/jobs/{doomed}/result")[0] == 410,
              "7c: the result of a cancelled job did not answer 410")
        post_job({"input": "/etc/passwd", "params": {}}, expect=403)
        post_job([1, 2], expect=400)
        post_job({"input": paths[0], "seed": [3]}, expect=400)
        for fmt in ("flac", "ogg"):  # served formats: accepted, then cancelled while queued
            served = post_job({"input": paths[0], "format": fmt})["job_id"]
            code, body = http_call(http.port, "DELETE", f"/v1/jobs/{served}")
            check(code == 200 and json.loads(body)["cancelled"] is True,
                  f"7c: DELETE of the {fmt} job answered {code}")
        err = post_job({"input": paths[0], "format": "mp3"}, expect=400)
        check(err["error"] == "unknown format 'mp3' (use wav/flac/ogg)", f"7c: mp3: {err}")
        check(http_call(http.port, "GET", "/v1/jobs/" + "0" * 32)[0] == 404, "7c: unknown job")
        check(http_call(http.port, "GET", "/v1/nothing")[0] == 404, "7c: unknown path")
        with socket.create_connection(("127.0.0.1", http.port), timeout=30) as sock:
            sock.sendall(b"POST /v1/upload HTTP/1.1\r\nHost: x\r\nContent-Length: "
                         + str(513 * 1024 * 1024).encode() + b"\r\nConnection: close\r\n\r\n")
            check(b"413" in sock.recv(64).split(b"\r\n", 1)[0], "7c: oversize body not 413")
        presets = json.loads(http_call(http.port, "GET", "/v1/presets")[1])["presets"]
        check("Smoke_Hall_v4.json" in presets, f"7c: presets {presets}")

        t0 = time.perf_counter()
        before = bank.launch_count
        svc.start()
        deadline = time.monotonic() + 300
        for entry, *_ in submitted_jobs:
            while True:
                status = json.loads(http_call(http.port, "GET", f"/v1/jobs/{entry['job_id']}")[1])
                if status["status"] != "queued":
                    break
                check(time.monotonic() < deadline, f"7c: job {entry['job_id']} still queued")
                time.sleep(0.02)
            check(status["status"] == "done", f"7c: job ended as {status}")
        out["launches"] += bank.launch_count - before
        jobs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for entry, path, p, seed, external in submitted_jobs:
            code, wav = http_call(http.port, "GET", f"/v1/jobs/{entry['job_id']}/result")
            check(code == 200 and wav[:4] == b"RIFF", f"7c: result answered {code}")
            audio, rate = wavio.read(path)
            bucket = sharding.bucket_length(audio.shape[0], rate)
            direct = sharding.render_batch(
                np.pad(audio, ((0, bucket - audio.shape[0]), (0, 0)))[None], rate, p,
                seeds=[seed], clip_lengths=[audio.shape[0]], pcm16_output=True,
                with_metrics=True, external_ir=wavio.read(ir_path)[0] if external else None,
                device=dev)[0]
            buf = io.BytesIO()
            wavio.write(buf, direct[0, :audio.shape[0] + direct.shape[1] - bucket], rate)
            check(wav == buf.getvalue(),
                  f"7c: the served WAV of job {entry['job_id']} differs from the direct render's")
        results_s = time.perf_counter() - t0
        stats = json.loads(http_call(http.port, "GET", "/v1/stats")[1])
        check(stats["jobs_done"] == 3 and stats["jobs_failed"] == 0 and stats["jobs_known"] == 6
              and stats["inflight_input_bytes"] == 0 and "fft_plans" in stats,
              f"7c: stats {stats}")
    finally:
        http.stop()
    timing["http"] = {"upload_5_files_s": upload_s, "three_jobs_s": jobs_s,
                      "three_results_s": results_s}
    print(f"[7c http] 4 clips of {n_http / RATE:.2f} s and a stereo IR uploaded; params, preset "
          f"and external-IR jobs done, their WAV bytes = wavio.write of the direct render's "
          f"PCM16; a queued job cancelled (410), 409 while queued, flac and ogg jobs "
          f"accepted (202), 400 (non-object, seed, an unknown format), 403, 404, 413 "
          f"answered; stats back to zero in-flight bytes", flush=True)
    out["timing"] = timing
    return out


def product_phase(np, torch, bank, work: str, seconds: float = CLI_SECONDS,
                  device: str = "cuda") -> dict:
    """Phase 8: the product surfaces.  8a ``process_audio_main_v41`` on a
    stereo WAV (Room / Stereo; Cathedral 300 / 5.1 with shelf EQ; an external
    stereo IR), each written WAV equal bit for bit to ``wavio``'s PCM16 of
    the port's ``pipeline.render`` with the same params and seed; 8b the
    visualizer's device STFT on channel 0 of the 5.1 render against the CPU
    and scipy; 8c the ``compat`` façade chained as the reference's monolith
    chains it, each call against ``device="cpu"``; 8d the studio over its
    HTTP server, the profiler, the analyzer UI, and — where matplotlib and
    PIL are installed — the visualizer PNG and the marker.  Returns the
    timings, the bank launches of 8a and 8d and the bank's worst error."""
    import importlib.util
    import threading
    import unittest.mock

    from audio_raytracing_studio_tpu_torch import RenderParams, compat, config
    from audio_raytracing_studio_tpu_torch.analysis import visualize
    from audio_raytracing_studio_tpu_torch.analysis.metrics import (
        calculate_audio_metrics, metrics_string)
    from audio_raytracing_studio_tpu_torch.app import analyzer_ui, api, studio
    from audio_raytracing_studio_tpu_torch.app.server import StudioHTTPServer
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.utils import runtime, wavio
    from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore

    dev = runtime.ensure_device(device)
    on_card = dev.type == "cuda"
    have = {"matplotlib": importlib.util.find_spec("matplotlib") is not None,
            "pil": importlib.util.find_spec("PIL") is not None}
    out = {"launches": 0, "bank_errs": [0.0, 0.0], **have}
    timing = {}
    path = lambda name: os.path.join(work, name)  # noqa: E731
    made = []  # temp files the handlers leave behind (NamedTemporaryFile(delete=False))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def controls(p):
        return [getattr(p, k) for k in config.PRESET_KEYS]

    def pcm(file):
        data, rate = wavio.read(file)
        return np.rint(data * 32768.0).astype(np.int32), rate

    rng = np.random.default_rng(0x8A)
    n = int(seconds * RATE)
    t = np.arange(n, dtype=np.float32) / RATE
    song = np.stack([0.35 * np.sin(2 * np.pi * 196 * t) * np.exp(-(t % 1.5)),
                     0.3 * np.sin(2 * np.pi * 294 * t + 0.5) * np.exp(-((t + 0.7) % 1.5))],
                    axis=1) + rng.standard_normal((n, 2), dtype=np.float32) * 0.01
    wavio.write(path("song.wav"), song, RATE)
    audio, _ = wavio.read(path("song.wav"))
    n_ir = int(0.4 * RATE)
    ir = (rng.standard_normal((n_ir, 2)) * np.exp(-np.arange(n_ir) / (0.05 * RATE))[:, None]
          * 0.3).astype(np.float32)
    wavio.write(path("ir.wav"), ir, RATE, subtype="FLOAT")
    ir_read, _ = wavio.read(path("ir.wav"))
    del song, t

    previous = runtime.set_default_device(str(dev))
    old_cwd = os.getcwd()
    os.chdir(work)  # the studio keeps its presets and its map beside the working directory
    try:
        # ---------------- 8a: the app's main path ----------------
        cases = [
            ("room_stereo", RenderParams(hall_type="Room", target_layout="Stereo"), None),
            ("cathedral_51_eq", RenderParams(hall_type="Cathedral", room_size=300.0,
                                             target_layout="5.1 (Standard)", bass_gain=1.6,
                                             treble_gain=0.7), None),
            ("external_ir", RenderParams(use_external_ir=True, target_layout="Stereo"),
             path("ir.wav")),
        ]
        refs = {}
        for label, p, ir_file in cases:
            internal = ir_file is None
            walls = []
            for attempt in range(2):  # the first call of a shape creates its cuFFT plans
                before = bank.launch_count
                sync()
                t0 = time.perf_counter()
                player, download, text = api.process_audio_main_v41(
                    path("song.wav"), None, ir_file, *controls(p), seed=3)
                walls.append(time.perf_counter() - t0)
                check(player is not None and player == download and os.path.isfile(player),
                      f"8a {label}: no result file: {text}")
                made.append(player)
                launched = bank.launch_count - before
                expected = 1 if internal and on_card else 0  # the plain version is not counted
                check(launched == expected,
                      f"8a {label}: {launched} bank calls, expected {expected}")
                out["launches"] += launched
            # the same render directly, and the call's wall split
            split = {}
            t0 = time.perf_counter()
            wavio.read(path("song.wav"))
            split["read_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref, ref_m = pipeline.render(
                audio, RATE, p, seed=3, external_ir=None if internal else ir_read,
                external_ir_rate=None if internal else RATE, return_metrics=True, device=dev)
            split["render_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            wavio.write(path("direct.wav"), np.clip(ref, -config.OUTPUT_CLIP, config.OUTPUT_CLIP),
                        RATE, subtype="PCM_16")
            split["clip_encode_write_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            shutil.copy2(path("direct.wav"), path("copy.wav"))
            split["player_copy_s"] = time.perf_counter() - t0
            with open(player, "rb") as a, open(path("direct.wav"), "rb") as b:
                served_bytes, direct_bytes = a.read(), b.read()
            check(served_bytes == direct_bytes,
                  f"8a {label}: the written WAV differs from wavio PCM16 of render()")
            check(text == metrics_string(ref_m),
                  f"8a {label}: metrics string {text!r} vs {metrics_string(ref_m)!r}")
            check(ref.shape[1] == config.CHANNEL_LAYOUTS[p.target_layout]["channels"]
                  and bool(np.isfinite(ref).all()) and float(np.abs(ref).max()) <= 1.0,
                  f"8a {label}: render {ref.shape}, peak {np.abs(ref).max()}")
            refs[label] = (ref, ref_m, served_bytes)
            timing[label] = {"first_call_s": walls[0], "call_s": walls[1], **split,
                             "wav_mb": len(served_bytes) / 1e6}
            line = (f"[8a app] {label}: process_audio_main_v41 -> {ref.shape} PCM16 WAV = wavio "
                    f"PCM16 of render() bit for bit, {text!r} = metrics_string(render's); wall "
                    f"{walls[1]:.3f} s (first {walls[0]:.3f} s; read {split['read_s']:.3f}, "
                    f"render() {split['render_s']:.3f}, clip+encode+write "
                    f"{split['clip_encode_write_s']:.3f}, player copy "
                    f"{split['player_copy_s']:.3f})")
            if internal:
                setup = pipeline.build_internal_setup(p, RATE, n)
                if on_card:
                    errs = hold_bank(np, torch, bank, f"8a {label}", setup.ir_shape,
                                     setup.ir_scalars, [3])
                    out["bank_errs"] = [max(a, b) for a, b in zip(out["bank_errs"], errs)]
                    line += (f"; bank B=1 length {setup.ir_shape.length} kernel vs plain "
                             f"{max(errs):.3e}")
            print(line, flush=True)

        # (i) again with the CPU as the process-wide device: the plain path
        runtime.set_default_device("cpu")
        before = bank.launch_count
        t0 = time.perf_counter()
        cpu_player, _, cpu_text = api.process_audio_main_v41(
            path("song.wav"), None, None, *controls(cases[0][1]), seed=3)
        timing["room_stereo"]["cpu_call_s"] = time.perf_counter() - t0
        runtime.set_default_device(str(dev))
        check(cpu_player is not None, f"8a CPU: {cpu_text}")
        made.append(cpu_player)
        check(bank.launch_count == before, "8a: the CPU call launched the CUDA bank")
        buf = io.BytesIO(refs["room_stereo"][2])
        a, b = pcm(buf)[0], pcm(cpu_player)[0]
        lsb = int(np.abs(a - b).max())
        cpu_ref = pipeline.render(audio, RATE, cases[0][1], seed=3, device="cpu")
        cpu_err = float(np.abs(refs["room_stereo"][0] - cpu_ref).max())
        check(a.shape == b.shape and lsb <= 1 and cpu_err <= RENDER_TOL,
              f"8a card vs CPU: {lsb} LSB, render {cpu_err} > {RENDER_TOL}")
        del cpu_ref, a, b
        timing["card_vs_cpu"] = {"pcm16_lsb": lsb, "render_max_abs": cpu_err}
        print(f"[8a app] room_stereo with the CPU as default device: PCM16 within {lsb} LSB, "
              f"render() card vs CPU {cpu_err:.3e} (tol {RENDER_TOL}); {cpu_text!r}", flush=True)
        # the error contract holds on the card too
        check(api.process_audio_main_v41(None, None, None, *controls(cases[0][1]))
              == (None, None, "Keine gültige Quelle"), "8a: no-source answer")
        wavio.write(path("mono_ir.wav"), ir[:, 0], RATE)
        check(api.process_audio_main_v41(path("song.wav"), None, path("mono_ir.wav"),
                                         *controls(cases[2][1]))
              == (None, None, "Externe IR muss Stereo sein."), "8a: mono IR answer")

        # ---------------- 8b: the device STFT ----------------
        six, six_m, _ = refs["cathedral_51_eq"]
        ch0 = np.ascontiguousarray(six[:, 0])
        nperseg = min(visualize.spectrogram_nperseg(ch0.shape[0] / RATE), ch0.shape[0])
        sync()
        t0 = time.perf_counter()
        f_d, t_d, s_d = visualize.compute_spectrogram(ch0, RATE, nperseg, use_device=True)
        stft_call_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        visualize.compute_spectrogram(ch0, RATE, nperseg, use_device=True)
        stft_call_again_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, s_c = visualize.compute_spectrogram(ch0, RATE, nperseg, use_device=True,
                                                  device="cpu")
        stft_cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f_s, t_s, s_s = visualize.compute_spectrogram(ch0, RATE, nperseg)
        stft_scipy_s = time.perf_counter() - t0
        check(s_d.shape == s_c.shape == s_s.shape == (nperseg // 2 + 1,
                                                      (ch0.shape[0] - nperseg) // (nperseg // 2) + 1),
              f"8b: STFT shapes {s_d.shape} {s_c.shape} {s_s.shape}")
        check(np.allclose(f_d, f_s) and np.allclose(t_d, t_s), "8b: STFT axes differ from scipy's")
        top = float(s_s.max())
        db = lambda m: 10 * np.log10(np.maximum(m, 1e-10))  # noqa: E731 — the plot's floor
        limits = lambda m: (max(np.median(db(m)) - 40, db(m).max() - 80), db(m).max())  # noqa: E731
        stft = {"samples": int(ch0.shape[0]), "nperseg": int(nperseg), "frames": int(s_d.shape[1]),
                "vs_cpu_rel": float(np.abs(s_d - s_c).max()) / top,
                "vs_scipy_rel": float(np.abs(s_d - s_s).max()) / top,
                "vs_cpu_db": float(np.abs(db(s_d) - db(s_c)).max()),
                "vs_scipy_db": float(np.abs(db(s_d) - db(s_s)).max()),
                "color_limits_moved_db": float(max(abs(a - b) for a, b in
                                                   zip(limits(s_d), limits(s_s)))),
                "call_with_upload_s": stft_call_again_s, "first_call_s": stft_call_s,
                "cpu_call_s": stft_cpu_s, "scipy_call_s": stft_scipy_s}
        check(stft["vs_cpu_rel"] <= STFT_TOL and stft["vs_scipy_rel"] <= STFT_TOL,
              f"8b: STFT power gap {stft} > {STFT_TOL} of the maximum")
        check(stft["color_limits_moved_db"] <= 0.01, f"8b: the plot's color limits moved {stft}")
        if on_card:
            x = torch.from_numpy(ch0).to(dev)
            win = torch.hann_window(nperseg, periodic=True, dtype=torch.float64).float().to(dev)
            stft["device_ms"] = cuda_ms(torch, lambda: visualize.stft_power(x, win, 1.0), 10)
            del x, win
        timing["stft"] = stft
        print(f"[8b stft] channel 0 of the 5.1 render: {stft['samples']} samples, nperseg "
              f"{nperseg}, {stft['frames']} frames; device vs CPU {stft['vs_cpu_rel']:.2e}, vs "
              f"scipy {stft['vs_scipy_rel']:.2e} of the maximum (tol {STFT_TOL}); above the "
              f"1e-10 floor {stft['vs_cpu_db']:.3f} / {stft['vs_scipy_db']:.3f} dB at most, "
              f"color limits moved {stft['color_limits_moved_db']:.2e} dB; "
              f"{stft.get('device_ms', float('nan')):.3f} ms on the device, "
              f"{1e3 * stft_call_again_s:.1f} ms with upload and copy back (scipy "
              f"{1e3 * stft_scipy_s:.1f} ms)", flush=True)
        del s_d, s_c, s_s

        # ---------------- 8c: compat on the card ----------------
        p = cases[1][1]
        gaps = {}

        def both(label, fn, pick=lambda r: r):
            """``fn(device=...)`` on the card and on the CPU → the card's
            result; ``pick`` names the array (or tuple of arrays) to compare,
            whose gap is recorded and held to RENDER_TOL."""
            arrays = lambda r: pick(r) if isinstance(pick(r), tuple) else (pick(r),)  # noqa: E731
            sync()
            t0 = time.perf_counter()
            got = fn(device=str(dev))
            wall = time.perf_counter() - t0
            want = fn(device="cpu")
            err = max(float(np.abs(a - b).max()) for a, b in zip(arrays(got), arrays(want)))
            check(err <= RENDER_TOL, f"8c {label}: card vs CPU {err} > {RENDER_TOL}")
            gaps[label] = {"max_abs": err, "card_call_s": wall}
            return got

        dur, refl, maxd, split_s = compat.adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
        direc = compat.compute_final_directionality_3d(p.x_pos, p.y_pos, p.z_pos, p.hall_type,
                                                       p.diffusion, p.dry_wet)
        early, late = both("generate_impulse_response_split_3d",
                           lambda device: compat.generate_impulse_response_split_3d(
                               RATE, dur, refl, maxd, p.material, direc, split_s, p.diffusion,
                               seed=3, device=device))
        el, ll = compat.adapt_early_late_levels(p.dry_wet, p.early_level, p.late_level)
        mixed = both("convolve_audio_split_3d", lambda device: compat.convolve_audio_split_3d(
            audio, early, late, el, ll, p.dry_wet, p.bass_gain, p.treble_gain, RATE,
            p.dry_wet_kill_start, p.air_absorption, device=device))
        surround = both("apply_surround_panning_3d", lambda device: compat.apply_surround_panning_3d(
            mixed, p.x_pos, p.y_pos, p.z_pos, device=device))
        mapped = both("map_channels 5.1", lambda device: compat.map_channels(
            surround, p.target_layout, RATE, p.z_pos, device=device), pick=lambda r: r[0])[0]
        chain_err = float(np.abs(mapped - six).max())
        check(mapped.shape == six.shape and chain_err <= RENDER_TOL,
              f"8c: the chain's end vs 8a's render {chain_err} > {RENDER_TOL}")
        for layout in ("7.1 (Surround)", "5.1.2 (Atmos Light)"):
            wide, names = both(f"map_channels {layout}", lambda device: compat.map_channels(
                surround, layout, RATE, 0.8, device=device), pick=lambda r: r[0])
            check(wide.shape == (surround.shape[0], 8) and len(names) == 8, f"8c: {layout} {wide.shape}")
        ext = both("convolve_audio_external_ir", lambda device: compat.convolve_audio_external_ir(
            audio, ir_read, 0.6, 1.4, 0.8, RATE, 0.5, device=device))
        check(ext.shape == (n + n_ir - 1, 2), f"8c: external {ext.shape}")
        both("apply_simple_lp_filter", lambda device: compat.apply_simple_lp_filter(
            mixed, RATE, 0.5, device=device))
        m_card = compat.calculate_audio_metrics(mapped, RATE, device=str(dev))
        m_cpu = compat.calculate_audio_metrics(mapped, RATE, device="cpu")
        d = check_metrics(m_card, m_cpu, "8c: calculate_audio_metrics card vs CPU")
        d_render = check_metrics(m_card, six_m, "8c: the chain's metrics vs 8a's render's")
        timing["compat"] = {"gaps": gaps, "chain_vs_render_max_abs": chain_err,
                            "metrics_card_vs_cpu": d, "metrics_chain_vs_render": d_render}
        print(f"[8c compat] IR, split convolve (EQ, air), pan, map 5.1 / 7.1 / 5.1.2, external "
              f"IR, LP filter on {seconds:.0f} s: card vs CPU max-abs "
              f"{max(g['max_abs'] for g in gaps.values()):.3e} at most (tol {RENDER_TOL}); the "
              f"chain's end vs 8a's render {chain_err:.3e}; metrics card vs CPU {max(d):.1e}, "
              f"vs the render's {max(d_render):.1e}", flush=True)
        del early, late, mixed, surround, mapped, ext, wide

        # ---------------- 8d: the studio over HTTP ----------------
        steps = ["upload", "process", "download", "profiler", "analyzer_ui"]
        store = PresetStore(work)
        server = StudioHTTPServer(studio.build_demo(store), host="127.0.0.1", port=0).start()
        try:
            def state():
                code, body = http_call(server.port, "GET", "/state")
                check(code == 200, f"8d: /state answered {code}")
                return json.loads(body)["components"]

            def by_label(comps, label, nth=0):
                return [c for c in comps if c["label"] == label][nth]

            def event(label, sets=None, nth=0):
                comps = state()
                payload = {"id": by_label(comps, label, nth)["id"], "event": "click",
                           "set": {str(by_label(comps, k)["id"]): v for k, v in (sets or {}).items()}}
                code, body = http_call(server.port, "POST", "/event", json.dumps(payload).encode())
                check(code == 200, f"8d: {label} answered {code}: {body[:300]}")
                return json.loads(body)["components"]

            comps = state()
            check(by_label(comps, "📊 Ergebnis-Metriken (Gesamt)")["value"]
                  == "Bereit. Bitte Audio laden.", "8d: the startup initializer did not run")
            marker_value = by_label(comps, "🎯 Position (X/Y)")["value"]
            if have["pil"]:
                check(marker_value and os.path.isfile(marker_value), "8d: no marker was drawn")
                made.append(marker_value)
                steps.append("startup marker")
            else:
                check(marker_value is None, f"8d: a marker without PIL: {marker_value}")
            with open(path("song.wav"), "rb") as fh:
                code, body = http_call(server.port, "POST", "/upload", fh.read(),
                                       {"X-Filename": "song.wav"})
            check(code == 200, f"8d: /upload answered {code}")
            uploaded = json.loads(body)["path"]
            # the button passes no seed: the draw comes from os.urandom; pin it to 8a's
            four = (3).to_bytes(4, "little")
            answer = {}
            before = bank.launch_count
            with unittest.mock.patch.object(os, "urandom", lambda k: (four * (k // 4 + 1))[:k]):
                t0 = time.perf_counter()
                worker = threading.Thread(target=lambda: answer.update(comps=event(
                    "➡️ Verarbeiten & Anhören!",
                    {"🔊 Audio hochladen": uploaded, "🎯 Ziel-Layout": "Stereo",
                     "🏛️ Hall-Typ": "Room"})))
                worker.start()
                polls = 0
                while worker.is_alive():  # state polls are not held up by the render
                    state()
                    polls += 1
                    time.sleep(0.01)
                worker.join()
                event_s = time.perf_counter() - t0
            check("comps" in answer, "8d: the process event failed")
            out["launches"] += bank.launch_count - before
            check(bank.launch_count - before == (1 if on_card else 0),
                  "8d: the process button did not make one bank call")
            result = by_label(state(), "🎧 Ergebnis anhören")
            check(result["value"] and result.get("url"), f"8d: no result in /state: {result}")
            made.append(result["value"])
            t0 = time.perf_counter()
            code, body = http_call(server.port, "GET", result["url"])
            download_s = time.perf_counter() - t0
            check(code == 200 and body == refs["room_stereo"][2],
                  f"8d: GET /file answered {code}, {len(body)} bytes; differs from 8a's WAV")
            text = by_label(answer["comps"], "📊 Ergebnis-Metriken (Gesamt)")["value"]
            check(text == metrics_string(refs["room_stereo"][1]), f"8d: metrics {text!r}")
            code, _ = http_call(server.port, "GET", "/file?path=" + path("direct.wav"))
            check(code == 403, f"8d: a file outside the allowlist answered {code}")
            # the profiler on (input, output)
            t0 = time.perf_counter()
            comps = event("🚀 Analysieren!", {"Lade Original (Profiler)": uploaded,
                                             "Lade Bearbeitet (Profiler)": result["value"]})
            profiler_s = time.perf_counter() - t0
            report = by_label(comps, "📋 Analysebericht")["value"]
            file_m = calculate_audio_metrics(wavio.read(result["value"])[0], RATE)
            check("Zusammenfassung" in report and f"{file_m['lufs']:.2f} LUFS" in report
                  and f"{seconds + (refs['room_stereo'][0].shape[0] - n) / RATE:.2f}s" in report,
                  f"8d: profiler report {report[:600]}")
            vis_s = None
            if have["matplotlib"]:
                t0 = time.perf_counter()
                comps = event("📊 Visualisieren", {"🔍 Original (Visualizer)": uploaded,
                                                  "🔍 Bearbeitet (Visualizer)": result["value"]})
                vis_s = time.perf_counter() - t0
                for label in ("🔵 Original Vis", "🟠 Bearbeitet Vis"):
                    img = by_label(comps, label)
                    code, png = http_call(server.port, "GET", img["url"])
                    check(code == 200 and png[:4] == b"\x89PNG" and len(png) > 10000,
                          f"8d: {label} answered {code}, {len(png)} bytes")
                    made.append(img["value"])
                steps.append("visualizer png")
        finally:
            server.stop()
        # the analyzer UI's handlers on the 6-channel file
        wavio.write(path("six.wav"), np.clip(six, -config.OUTPUT_CLIP, config.OUTPUT_CLIP), RATE,
                    subtype="PCM_16")
        demo = analyzer_ui.build_demo()
        demo.set_value("Audiodatei hochladen", path("six.wav"))
        t0 = time.perf_counter()
        demo.fire(demo.get("Analysieren"), "click")
        analyze_s = time.perf_counter() - t0
        res = json.loads(demo.get("Analyse").value)
        check(res["Kanäle"] == 6 and abs(res["LUFS"] - six_m["lufs"]) <= 0.02,
              f"8d: do_analyze {res} vs {six_m}")
        demo.set_value("Ziel-LUFS", -16)
        demo.fire(demo.get("Auf Ziel-LUFS normalisieren"), "click")
        norm = demo.get("Normalisierte Datei").value
        check(norm and os.path.isfile(norm), f"8d: do_normalize: {demo.get('Bericht').value}")
        made.append(norm)
        lufs_n = calculate_audio_metrics(wavio.read(norm)[0], RATE)["lufs"]
        check(abs(lufs_n + 16.0) <= 0.05, f"8d: normalized to {lufs_n} LUFS")
        timing["http"] = {"process_event_s": event_s, "state_polls_during_event": polls,
                          "download_s": download_s, "profiler_event_s": profiler_s,
                          "visualizer_event_s": vis_s, "analyzer_do_analyze_s": analyze_s}
        out["steps"] = steps
        print(f"[8d studio] {json.dumps(have)} steps {steps}: upload, process button over POST "
              f"/event ({event_s:.3f} s, {polls} /state polls meanwhile), GET /file = 8a's WAV "
              f"bit for bit, 403 outside the allowlist, profiler report on (input, output), "
              f"analyzer UI on the 6-channel file (LUFS {res['LUFS']}, normalized to "
              f"{lufs_n:.3f})", flush=True)
    finally:
        os.chdir(old_cwd)
        runtime.set_default_device(previous)
        for file in made:
            if file and os.path.exists(file):
                os.remove(file)
    out["timing"] = timing
    return out


def streaming_phase(np, torch, bank, work: str, minutes: float = LONG_MINUTES,
                    device: str = "cuda") -> dict:
    """Phase 9: one long clip through the chunked streaming renderer.  9a
    streaming fast, exact and exact + EQ against the single-shot ``render``
    of the same ``minutes`` clip (5.1, room 200, seed 1, 30 s chunks, metrics
    on; ``tools.bench_long``'s setting and timings), PCM16 on the device
    against ``wavio``'s; 9b chunk invariance; 9c the exact-length filters
    against float64 cuFFT at the render's length; 9d the card against the
    CPU; 9e ``cli.render --stream``, a routed ``RenderService`` job among 48
    short ones and the HTTP API on a long clip; 9f the bank at every
    streaming shape; 9g device memory of single-shot and streaming renders.
    Every clip length scales with ``minutes`` (30 on the card; a short one
    for the CPU rehearsal, where the card-only steps are left out).  Returns
    the timings, the counted bank launches of the renders and the bank's
    worst error against its plain version."""
    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.cli import render as cli_render
    from audio_raytracing_studio_tpu_torch.config import OUTPUT_CLIP
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import filters, ir_synth
    from audio_raytracing_studio_tpu_torch.parallel import sharding, streaming, streaming_eq
    from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService
    from audio_raytracing_studio_tpu_torch.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu_torch.tools import bench_long as bl
    from audio_raytracing_studio_tpu_torch.utils import wavio

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    scale = minutes / LONG_MINUTES
    n_long = int(minutes * 60 * RATE)
    out = {"launches": 0, "bank_errs": [0.0, 0.0]}
    timing = {"minutes": minutes, "chunk_s": STREAM_CHUNK_S, "walls_s": {}}
    t_phase = [time.perf_counter()]

    def lap(name):
        """The host wall of the sub-phase that ends here."""
        now = time.perf_counter()
        timing["walls_s"][name] = now - t_phase[0]
        t_phase[0] = now

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counted(fn):
        """Run ``fn`` (renders only, never a bank check) and count its bank calls."""
        before = bank.launch_count
        result = fn()
        out["launches"] += bank.launch_count - before
        return result

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        result = counted(fn)
        sync()
        return result, time.perf_counter() - t0

    def clear_plans():
        if on_card:
            torch.backends.cuda.cufft_plan_cache.clear()
            torch.cuda.empty_cache()

    def quantize(x):
        return wavio.encode_pcm16(np.clip(x, -OUTPUT_CLIP, OUTPUT_CLIP))

    def lsb(a, b):
        return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())

    stream_kw = dict(seed=bl.SEED, chunk_seconds=STREAM_CHUNK_S * scale, device=dev)
    p = RenderParams(target_layout=bl.LAYOUT, room_size=bl.ROOM_SIZE)
    p_eq = dataclasses.replace(p, bass_gain=1.6, treble_gain=0.7)
    clip = bl.make_long_clip(minutes)
    setup = pipeline.build_internal_setup(p, RATE, n_long)
    len_out = setup.spec.len_out
    timing["len_out"] = len_out
    timing["ir_length"] = setup.ir_shape.length

    # ---------------- 9a: streaming against single-shot ----------------
    clear_plans()
    singles = {}
    for label, params in (("plain", p), ("eq", p_eq)):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        (ref, ref_m), wall = timed(lambda: pipeline.render(
            clip, RATE, params, seed=bl.SEED, fast_filters=False, return_metrics=True,
            device=dev))
        check(ref.shape == (len_out, 6) and np.isfinite(ref).all(),
              f"9a single-shot {label}: {ref.shape}")
        singles[label] = (ref, ref_m)
        timing[f"single_{label}_s"] = wall
        if on_card:
            timing[f"single_{label}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if on_card:
        timing["single_outside_allocator_gb"] = outside_allocator(torch) / 1e9
    clear_plans()
    figures = {}
    results = {}
    for exact in (False, True):
        mode = "exact" if exact else "fast"
        if on_card:  # tools.bench_long: four renders, the PCM16 check among them
            fig, res, res_m = counted(lambda: bl.bench_long(clip, exact=exact, device=dev))
        else:
            fig = None
            res, res_m = counted(lambda: streaming.render_streaming(
                clip, RATE, p, fast_filters=not exact, with_metrics=True, **stream_kw))
        figures[mode] = fig
        results[mode] = (res, res_m)
        check(fig is None or fig["pcm16_bit_identical"],
              f"9a {mode}: PCM16 on the device differs from wavio's")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    (res_eq, res_eq_m), wall = timed(lambda: streaming.render_streaming(
        clip, RATE, p_eq, fast_filters=False, with_metrics=True, **stream_kw))
    timing["stream_exact_eq_s"] = wall
    if on_card:
        timing["stream_exact_eq_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    results["exact_eq"] = (res_eq, res_eq_m)
    q_eq, wall = timed(lambda: streaming.render_streaming(
        clip, RATE, p_eq, fast_filters=False, pcm16_output=True, **stream_kw))
    timing["stream_exact_eq_pcm16_s"] = wall
    check(q_eq.dtype == np.int16 and np.array_equal(q_eq, quantize(res_eq)),
          "9a exact + EQ: PCM16 on the device differs from wavio's")
    del q_eq
    errs = {}
    for mode, single, tol in (("fast", "plain", FAST_AIR_TOL), ("exact", "plain", STREAM_TOL),
                              ("exact_eq", "eq", STREAM_TOL)):
        res, res_m = results[mode]
        ref, ref_m = singles[single]
        err = max_abs(np, torch, res, ref)
        check(err <= tol, f"9a streaming {mode} vs single-shot: {err} > {tol}")
        errs[mode] = {"max_abs": err, "metric_d": check_metrics(res_m, ref_m, f"9a {mode}")}
    timing["vs_single_shot"] = errs
    timing["bench_long"] = figures
    print(f"[9a streaming] {minutes:g} min 5.1 room 200: len_out {len_out}, chunks of "
          f"{STREAM_CHUNK_S * scale:g} s; vs single-shot exact: fast {errs['fast']['max_abs']:.3e} "
          f"(tol {FAST_AIR_TOL}), exact {errs['exact']['max_abs']:.3e}, exact + EQ "
          f"{errs['exact_eq']['max_abs']:.3e} (tol {STREAM_TOL}); metrics within "
          f"{max(max(e['metric_d']) for e in errs.values()):.2e}; PCM16 on the device = wavio's",
          flush=True)
    exact_out = results["exact"][0]
    del results, singles, res, ref

    # stage split of one exact + EQ render and one fast render, by CUDA events
    if on_card:
        audio_nc = clip[:, None]
        for mode, params, fast in (("fast", p, True), ("exact_eq", p_eq, False)):
            events = {name: torch.cuda.Event(enable_timing=True)
                      for name in ("start", "plan", "pass1", "filters", "pass2", "meter")}
            events["start"].record()
            plan = counted(lambda: streaming._plan(audio_nc, RATE, params, bl.SEED,
                                                   STREAM_CHUNK_S, True, None, None, fast, dev))
            events["plan"].record()
            out_cn = streaming._render_on_device(audio_nc, plan, dev,
                                                 stage=lambda name: events[name].record())
            streaming._streaming_metrics(out_cn, RATE, len_out, plan.chunk, plan.n_chunks)
            events["meter"].record()
            torch.cuda.synchronize()
            names = list(events)
            timing[f"stages_{mode}_ms"] = {
                b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
            timing["n_chunks"] = plan.n_chunks
            del out_cn
        # the card's busy share over one compute-only exact + EQ render
        timing["busy_exact_eq"] = busy_share(torch, lambda: counted(
            lambda: streaming.render_streaming(clip, RATE, p_eq, fast_filters=False,
                                               with_metrics=True, return_output=False,
                                               **stream_kw)))

    lap("9a")

    # ---------------- 9b: chunk invariance ----------------
    five = clip[: int(5 * 60 * RATE * scale)]
    inv = {}
    for fast in (True, False):
        a = counted(lambda: streaming.render_streaming(
            five, RATE, p, fast_filters=fast, **dict(stream_kw, chunk_seconds=30.0 * scale)))
        b = counted(lambda: streaming.render_streaming(
            five, RATE, p, fast_filters=fast, **dict(stream_kw, chunk_seconds=7.3 * scale)))
        inv["fast" if fast else "exact"] = max_abs(np, torch, a, b)
        check(inv["fast" if fast else "exact"] <= INVARIANCE_TOL,
              f"9b chunk invariance {inv} > {INVARIANCE_TOL}")
    timing["chunk_invariance"] = inv
    print(f"[9b invariance] {five.shape[0] / RATE:g} s, chunks {30.0 * scale:g} s vs "
          f"{7.3 * scale:g} s: fast {inv['fast']:.3e}, exact {inv['exact']:.3e} "
          f"(tol {INVARIANCE_TOL})", flush=True)

    lap("9b")

    # ---------------- 9c: the exact-length filters at len_out ----------------
    if on_card:
        n0 = len_out
        x = torch.from_numpy(np.ascontiguousarray(exact_out[:, :2].T)).to(dev)
        peak = x.abs().max().item()
        bg = torch.tensor([1.6], device=dev)
        tg = torch.tensor([0.7], device=dev)
        fac = torch.tensor([p.air_absorption], device=dev)
        filt = {}
        for name, stream_fn, gain in (
            ("shelf_eq", lambda: streaming_eq.shelf_eq_streaming(x, n0, RATE, bg, tg),
             lambda: filters.shelf_eq_gain(n0, RATE, bg, tg)[0]),
            ("air", lambda: streaming_eq.air_absorption_streaming(x, n0, RATE, fac),
             lambda: filters.air_absorption_gain(n0, RATE, fac)[0]),
        ):
            clear_plans()
            base = outside_allocator(torch)
            g = gain()
            ref = torch.fft.irfft(torch.fft.rfft(x.double(), n=n0) * g.double(), n=n0)
            outside64 = outside_allocator(torch) - base
            clear_plans()
            base = outside_allocator(torch)
            torch.cuda.reset_peak_memory_stats()
            alloc0 = torch.cuda.memory_allocated()
            ours = stream_fn()
            ours_peak = torch.cuda.max_memory_allocated() - alloc0
            ours_outside = outside_allocator(torch) - base
            err_ours = (ours.double() - ref).abs().max().item() / peak
            del ours
            base = outside_allocator(torch)
            spec = torch.fft.rfft(x, n=n0)
            one_plan = outside_allocator(torch) - base
            pair = torch.fft.irfft(spec * g, n=n0)
            pair_outside = outside_allocator(torch) - base
            err_pair = (pair.double() - ref).abs().max().item() / peak
            del spec, pair, ref
            ours_ms = cuda_ms(torch, stream_fn, 3)
            pair_ms = cuda_ms(torch, lambda: torch.fft.irfft(torch.fft.rfft(x, n=n0) * g, n=n0), 3)
            check(err_ours <= STREAM_TOL, f"9c {name}: Bluestein vs float64 {err_ours}")
            filt[name] = {"bluestein_rel_err": err_ours, "cufft_pair_rel_err": err_pair,
                          "bluestein_ms": ours_ms, "cufft_pair_ms": pair_ms,
                          "bluestein_peak_alloc_gb": ours_peak / 1e9,
                          "bluestein_outside_allocator_gb": ours_outside / 1e9,
                          "cufft_rfft_plan_outside_allocator_gb": one_plan / 1e9,
                          "cufft_pair_plans_outside_allocator_gb": pair_outside / 1e9,
                          "float64_pair_plans_outside_allocator_gb": outside64 / 1e9}
        clear_plans()
        timing["exact_length_filters"] = {"n0": n0, "m": streaming_eq.bluestein_length(n0), **filt}
        print(f"[9c exact length] n0 {n0} (m {streaming_eq.bluestein_length(n0)}): max-abs vs "
              f"float64 cuFFT / signal max: EQ Bluestein {filt['shelf_eq']['bluestein_rel_err']:.2e}"
              f" (cuFFT pair {filt['shelf_eq']['cufft_pair_rel_err']:.2e}), air "
              f"{filt['air']['bluestein_rel_err']:.2e} ({filt['air']['cufft_pair_rel_err']:.2e}); "
              f"one float32 exact-length plan holds "
              f"{filt['shelf_eq']['cufft_rfft_plan_outside_allocator_gb']:.2f} GB outside the "
              f"allocator, the Bluestein's plans "
              f"{filt['shelf_eq']['bluestein_outside_allocator_gb']:.2f} GB", flush=True)
        del x
    del exact_out

    lap("9c")

    # ---------------- 9d: the card against the CPU ----------------
    if on_card:
        short = clip[: int(90 * RATE * scale)]
        card_cpu = {}
        for mode, params, fast in (("fast", p, True), ("exact_eq", p_eq, False)):
            got = {d: counted(lambda: streaming.render_streaming(
                short, RATE, params, fast_filters=fast,
                **dict(stream_kw, chunk_seconds=20.0 * scale, device=d))) for d in ("cuda", "cpu")}
            err = max_abs(np, torch, got["cuda"], got["cpu"])
            bits = lsb(quantize(got["cuda"]), quantize(got["cpu"]))
            check(err <= CARD_CPU_TOL and bits <= 1,
                  f"9d {mode}: card vs CPU {err} (tol {CARD_CPU_TOL}), {bits} LSB")
            card_cpu[mode] = {"max_abs": err, "pcm16_lsb": bits}
        timing["card_vs_cpu"] = card_cpu
        print(f"[9d card vs CPU] {short.shape[0] / RATE:g} s, 20 s chunks: fast "
              f"{card_cpu['fast']['max_abs']:.3e}, exact + EQ {card_cpu['exact_eq']['max_abs']:.3e} "
              f"(tol {CARD_CPU_TOL}); PCM16 within "
              f"{max(c['pcm16_lsb'] for c in card_cpu.values())} LSB", flush=True)

    lap("9d")

    # ---------------- 9e: the routes ----------------
    long_s = 12 * 60 * scale
    threshold = 600.0 * scale
    twelve = clip[: int(long_s * RATE)]
    wav_in = os.path.join(work, "long.wav")
    wavio.write(wav_in, twelve, RATE)
    decoded, _ = wavio.read(wav_in)
    direct_q, direct_m = counted(lambda: streaming.render_streaming(
        decoded, RATE, p, fast_filters=False, with_metrics=True, pcm16_output=True, **stream_kw))
    direct_bytes = io.BytesIO()
    wavio.write(direct_bytes, direct_q, RATE)
    direct_bytes = direct_bytes.getvalue()
    routes = {"clip_s": long_s, "wav_mb": os.path.getsize(wav_in) / 1e6}
    # cli.render --stream
    wav_out = os.path.join(work, "long_out.wav")
    stdout, routes["cli_s"] = counted(lambda: run_cli(cli_render.main, [
        wav_in, wav_out, "--stream", "--metrics", "--json", "--layout", bl.LAYOUT,
        "--room-size", bl.ROOM_SIZE, "--seed", bl.SEED, "--chunk-seconds",
        STREAM_CHUNK_S * scale, "--device", device]))
    with open(wav_out, "rb") as f:
        check(f.read() == direct_bytes, "9e: cli.render --stream wrote other bytes than the "
              "direct render_streaming")
    check(json.loads(stdout)[0]["metrics"] == direct_m,
          f"9e: the CLI's metrics {stdout} vs {direct_m}")
    # RenderService: the long job among 48 short ones, submitted at once
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips

    shorts = bench_clips(BATCH, DURATION_S * scale)
    short_p = RenderParams(target_layout="Stereo")
    n_short = shorts.shape[1]
    svc = RenderService(max_batch=BATCH, max_wait_ms=2000, pcm16_output=True,
                        streaming_threshold_s=threshold, chunk_seconds=STREAM_CHUNK_S * scale,
                        max_queued=2 * BATCH, device=dev)
    before = bank.launch_count  # the worker renders from the first submit on
    try:
        t0 = time.perf_counter()
        futs = [svc.submit(RenderJob(twelve, RATE, p, seed=bl.SEED, with_metrics=True))]
        futs += [svc.submit(RenderJob(shorts[i], RATE, short_p, seed=500 + i, with_metrics=True))
                 for i in range(BATCH)]
        served = wait_all(futs, timeout=600)
        routes["service_s"] = time.perf_counter() - t0
        st = svc.stats()
    finally:
        svc.stop()
    out["launches"] += bank.launch_count - before
    check(sorted(st["batch_sizes"]) == [1, BATCH] and st["jobs_failed"] == 0
          and st["inflight_input_bytes"] == 0,
          f"9e service: batches {st['batch_sizes']}, {st['jobs_failed']} failed, "
          f"{st['inflight_input_bytes']} bytes in flight")
    direct_long = counted(lambda: streaming.render_streaming(
        twelve, RATE, p, fast_filters=False, with_metrics=True, pcm16_output=True, **stream_kw))
    check(np.array_equal(served[0].audio, direct_long[0]) and served[0].metrics == direct_long[1],
          "9e service: the routed long job differs from the direct render_streaming")
    bucket = sharding.bucket_length(n_short, RATE)
    padded = np.zeros((BATCH, bucket), np.float32)
    padded[:, :n_short] = shorts
    rows, rows_m = counted(lambda: sharding.render_batch(
        padded, RATE, short_p, seeds=[500 + i for i in range(BATCH)], with_metrics=True,
        clip_lengths=[n_short] * BATCH, pcm16_output=True, device=dev))
    real = n_short + rows.shape[1] - bucket
    for i, r in enumerate(served[1:]):
        check(np.array_equal(r.audio, rows[i, :real]) and r.metrics == rows_m[i],
              f"9e service: short job {i} differs from its direct render_batch row")
    routes["service_batches"] = st["batch_sizes"]
    del served, rows, direct_long
    # the HTTP job API
    http = RenderHTTPService(
        RenderService(max_batch=4, max_wait_ms=20, pcm16_output=True,
                      streaming_threshold_s=threshold, chunk_seconds=STREAM_CHUNK_S * scale,
                      device=dev),
        host="127.0.0.1", port=0).start()
    before = bank.launch_count
    try:
        t0 = time.perf_counter()
        with open(wav_in, "rb") as f:
            code, body = http_call(http.port, "POST", "/v1/upload", f.read(),
                                   {"X-Filename": "long.wav"})
        check(code == 200, f"9e http: upload answered {code}")
        code, body = http_call(http.port, "POST", "/v1/jobs", json.dumps(
            {"input": json.loads(body)["path"], "params": p.to_preset_dict(),
             "seed": bl.SEED}).encode())
        check(code == 202, f"9e http: POST /v1/jobs answered {code}: {body[:200]}")
        job_id = json.loads(body)["job_id"]
        deadline = time.monotonic() + 600
        while True:
            status = json.loads(http_call(http.port, "GET", f"/v1/jobs/{job_id}")[1])
            if status["status"] != "queued":
                break
            check(time.monotonic() < deadline, "9e http: the long job is still queued")
            time.sleep(0.05)
        check(status["status"] == "done", f"9e http: the long job ended as {status}")
        code, wav = http_call(http.port, "GET", f"/v1/jobs/{job_id}/result")
        routes["http_s"] = time.perf_counter() - t0
        stats = json.loads(http_call(http.port, "GET", "/v1/stats")[1])
    finally:
        http.stop()
    out["launches"] += bank.launch_count - before
    check(stats["batch_sizes"] == [1] and stats["jobs_done"] == 1,
          f"9e http: batches {stats['batch_sizes']}, {stats['jobs_done']} done")
    check(code == 200 and wav == direct_bytes,
          "9e http: the served WAV differs from the direct render_streaming's")
    timing["routes"] = routes
    print(f"[9e routes] {long_s:g} s clip ({routes['wav_mb']:.1f} MB WAV): cli.render --stream "
          f"{routes['cli_s']:.2f} s, bytes = the direct call's; RenderService batches "
          f"{st['batch_sizes']} (the long job routed, 48 short jobs = their render_batch rows) in "
          f"{routes['service_s']:.2f} s; HTTP upload + job + result {routes['http_s']:.2f} s, "
          f"bytes = the direct call's", flush=True)

    lap("9e")

    # ---------------- 9f: the bank at the streaming shapes ----------------
    if on_card:
        for label, shape_setup, seeds in (
            ("streaming room 200 B=1", setup, [bl.SEED]),
            ("9e short jobs B=48", pipeline.build_internal_setup(short_p, RATE, n_short),
             [500 + i for i in range(BATCH)]),
        ):
            errs = hold_bank(np, torch, bank, label, shape_setup.ir_shape,
                             shape_setup.ir_scalars, seeds)
            out["bank_errs"] = [max(a, b) for a, b in zip(out["bank_errs"], errs)]
        print(f"[9f bank] B=1 x {setup.ir_shape.length} (every streaming render) and the 9e "
              f"group: kernel vs plain max-abs early {out['bank_errs'][0]:.3e} late "
              f"{out['bank_errs'][1]:.3e} (tol {BANK_TOL})", flush=True)

    lap("9f")

    # ---------------- 9g: device memory, single-shot against streaming ----------------
    if on_card:
        memory = {}
        for mins in (minutes, 2 * minutes):
            x = clip if mins == minutes else np.concatenate([clip, clip])
            for layout in ("Stereo", bl.LAYOUT):
                params = dataclasses.replace(p_eq, target_layout=layout)
                for path in ("single", "streaming"):
                    clear_plans()
                    base = outside_allocator(torch)
                    torch.cuda.reset_peak_memory_stats()
                    alloc0 = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    if path == "single":
                        s = pipeline.build_internal_setup(params, RATE, x.shape[0])
                        audio_t = torch.from_numpy(x).to(dev).expand(1, 2, -1)
                        mix = pipeline.MixScalars.stack([s.mix_scalars], dev)
                        seeds = ir_synth.to_device(ir_synth.seeds_to_int32([bl.SEED]), dev)
                        early, late = counted(lambda: bank.fused_rir_bank(
                            seeds, s.ir_shape, s.ir_scalars))
                        res = pipeline.internal_graph_with_irs(audio_t, early, late, mix, s.spec)
                    else:
                        plan = counted(lambda: streaming._plan(
                            x[:, None], RATE, params, bl.SEED, STREAM_CHUNK_S * scale, True,
                            None, None, False, dev))
                        res = streaming._render_on_device(x[:, None], plan, dev)
                    torch.cuda.synchronize()
                    memory[f"{path}_{mins:g}min_{layout}"] = {
                        "peak_alloc_gb": (torch.cuda.max_memory_allocated() - alloc0) / 1e9,
                        "outside_allocator_gb": (outside_allocator(torch) - base) / 1e9,
                        "wall_s": time.perf_counter() - t0,
                    }
                    del res
        clear_plans()
        timing["memory"] = memory
        print("[9g memory] peak allocated / outside the allocator, GB, exact + EQ: " + ", ".join(
            f"{k} {v['peak_alloc_gb']:.2f} / {v['outside_allocator_gb']:.2f}"
            for k, v in memory.items()), flush=True)
    lap("9g")
    out["timing"] = timing
    return out


class BankRecorder:
    """Records each distinct (shape, batch) the bank's wrappers are called
    with while it is installed, so that a phase can hold every bank call it
    made against the plain version afterwards.  The wrappers stay the ones
    that count: the recorder calls them unchanged."""

    def __init__(self, bank):
        self.bank = bank
        self.hash, self.injected = {}, {}

    def __enter__(self):
        bank = self.bank
        self.originals = bank._rir_block_cuda, bank._rir_bank_cuda

        def block(seeds, scal, shape):
            self.hash.setdefault((shape, seeds.shape[0]), (seeds.clone(), scal.clone()))
            return self.originals[0](seeds, scal, shape)

        def injected(d, st, n, scal, shape):
            self.injected.setdefault((shape, d.shape[0]),
                                     (d.clone(), st.clone(), n.clone(), scal.clone()))
            return self.originals[1](d, st, n, scal, shape)

        bank._rir_block_cuda, bank._rir_bank_cuda = block, injected
        return self

    def __exit__(self, *exc):
        self.bank._rir_block_cuda, self.bank._rir_bank_cuda = self.originals
        return False

    def hold(self, torch) -> list:
        """Each recorded call again, kernel against plain → [worst hash-draws
        max-abs, worst injected max-abs], each ≤ BANK_TOL."""
        bank = self.bank
        worst = [0.0, 0.0]
        for (shape, batch), (seeds, scal) in self.hash.items():
            kern = bank._rir_block_cuda(seeds, scal, shape)
            plain = bank._rir_block_plain(seeds, scal, shape)
            errs = [(k - q).abs().max().item() for k, q in zip(kern, plain)]
            check(max(errs) <= BANK_TOL, f"bank at {shape} B={batch}: {errs} > {BANK_TOL}")
            worst[0] = max(worst[0], *errs)
        for (shape, batch), (d, st, n, scal) in self.injected.items():
            *kern, raw_k = bank._rir_bank_cuda(d, st, n, scal, shape)
            *plain, raw_p = bank._rir_bank_plain(d, st, n, scal, shape)
            check(torch.equal(raw_k, raw_p), f"injected bank at {shape}: raw-noise flags differ")
            errs = [(k - q).abs().max().item() for k, q in zip(kern, plain)]
            check(max(errs) <= BANK_TOL,
                  f"injected bank at {shape} B={batch}: {errs} > {BANK_TOL}")
            worst[1] = max(worst[1], *errs)
        torch.cuda.synchronize()
        return worst


def run_tool(main, argv) -> tuple:
    """A tool's ``main(argv)`` in this process, its stdout captured → (exit
    code, the JSON objects it printed, host seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    lines = []
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            lines.append(json.loads(line))
    return rc, lines, wall


def tooling_phase(np, torch, bank, work: str, rtf: dict, device: str = "cuda",
                  small: bool = False) -> dict:
    """Phase 10: the port's tools, each through its ``main(argv)`` in this
    process, its JSON line printed and checked.  10a ``tools.bench`` at its
    defaults; 10b ``tools.profile_exact`` (the stage chain reproduces the
    whole render); 10c ``tools.bench_long bank --batch 16`` (the bank's and
    the plain IR path's renders agree); 10d ``tools.bench_serving``: the
    burst, ``--soak 15``, ``--matrix --soak 8``, the WAV-only ``--http
    --soak 15`` at 2 jobs/s and the mixed-codec ``--http --soak 20
    --arrival-rate 0.5``, each with no failed job (every result of its true
    length and not silent);
    10e ``tools.fuzz_campaign`` parity 6, batch 3 and streaming 3 with no
    finding.  ``small`` shrinks every size for the CPU rehearsal.  Returns
    the lines, the walls, the bank calls the tools made (counted before the
    holds, which do not count) and the bank's worst errors against its
    plain version over every (shape, batch) the phase called it with."""
    from audio_raytracing_studio_tpu_torch.tools import (bench, bench_long, bench_serving,
                                                         fuzz_campaign, profile_exact)

    dev = ["--device", device]
    if small:
        bench_args = ["--batch", "2", "--seconds", "0.5"]
        serve_args = ["--jobs", "4", "--seconds", "0.5", "--rate", "16000",
                      "--soak-durations", "0.3,0.7", "--warm-buckets", "2",
                      "--arrival-rate", "4"]
        soaks = ("2", "1", "2", "2")
        http_rate = []
        fuzz = (("parity", "2"), ("batch", "2"), ("streaming", "2"))
    else:
        bench_args, serve_args = [], []
        soaks = ("15", "8", "15", "20")
        # the mixed-codec HTTP soak's FLAC / Ogg uploads and results are host
        # codec work on the request threads under one GIL: at the tool's 2
        # jobs/s it falls behind on an H100 machine without the FFmpeg
        # libraries (PERF.md section 6), so it runs at 0.5 jobs/s for 20 s
        # (about 10 jobs) beside the WAV-only soak at 2 jobs/s; its line
        # splits each job's wall, so what the codecs cost every job shows
        http_rate = ["--arrival-rate", "0.5"]
        fuzz = (("parity", "6"), ("batch", "3"), ("streaming", "3"))
    lines, walls = {}, {}

    def tool(label, main, argv):
        rc, printed, wall = run_tool(main, argv + dev)
        check(rc == 0 and printed, f"{label}: exit {rc}, lines {printed}")
        walls[label] = wall
        lines[label] = printed[-1]
        for obj in printed:
            print(f"[{label}] " + json.dumps(obj), flush=True)
        return printed

    with BankRecorder(bank) as recorder:
        line = tool("10a bench", bench.main, bench_args)[-1]
        check(line["value"] > 0 and line["value_exact"] > 0, f"10a: {line}")
        check("settled_fast" in line and "settled_exact" in line, f"10a: settle keys in {line}")
        print(f"[10a bench] beside phase 5: fast {line['value']:.1f} vs {rtf.get('fast')}, "
              f"exact {line['value_exact']:.1f} vs {rtf.get('exact')} audio-s/s", flush=True)

        line = tool("10b profile_exact", profile_exact.main,
                    ["--iters", "1"] + bench_args if small else [])[-1]
        check(line["chain_max_abs_err"] <= INVARIANCE_TOL,
              f"10b: stage chain vs the whole render {line['chain_max_abs_err']}")

        line = tool("10c bench_long bank", bench_long.main,
                    ["bank", "--batch", "2" if small else "16"]
                    + (["--seconds", "0.5"] if small else []))[-1]
        check(line["max_abs_bank_vs_jnp"] <= RENDER_TOL,
              f"10c: bank vs plain IR path {line['max_abs_bank_vs_jnp']} > {RENDER_TOL}")

        for label, argv in (("10d burst", []), ("10d soak", ["--soak", soaks[0]]),
                            ("10d matrix", ["--matrix", "--soak", soaks[1]]),
                            ("10d http wav", ["--http", "--soak", soaks[2],
                                              "--http-formats", "wav"]),
                            ("10d http", ["--http", "--soak", soaks[3]] + http_rate)):
            for obj in tool(label, bench_serving.main, serve_args + argv):
                check(obj.get("failed") == 0, f"{label}: {obj}")
            if label.startswith("10d http"):
                line = lines[label]
                check(line["completed"] == line["submitted"] > 0
                      and set(line["split_s"]) == set(bench_serving.HTTP_SPLIT),
                      f"{label}: {line}")
                print(f"[{label}] {line['completed']} jobs, p50 {line['latency_p50_s']:.3f} s, "
                      f"p95 {line['latency_p95_s']:.3f} s; split p50 / max (s): "
                      + ", ".join(f"{k} {v['p50']:.3f} / {v['max']:.3f}"
                                  for k, v in line["split_s"].items())
                      + f"; slowest {json.dumps(line['slowest'])}", flush=True)

        for mode, cases in fuzz:
            findings = os.path.join(work, f"fuzz_{mode}.jsonl")
            line = tool(f"10e fuzz {mode}", fuzz_campaign.main,
                        [mode, cases, "--findings", findings])[-1]
            check(line["findings"] == 0, f"10e fuzz {mode}: {line}")
    launches = {"launches": bank.launch_count, "injected_launches": bank.injected_launch_count}
    errs = recorder.hold(torch) if torch.device(device).type == "cuda" else [0.0, 0.0]
    return {"lines": lines, "walls_s": walls, "bank_errs": errs, **launches,
            "held": {"hash": len(recorder.hash), "injected": len(recorder.injected)}}


def snr_db(np, ref, got) -> float:
    """10 log10(Σ ref² / Σ (got − ref)²) in float64: the JAX suites' bound."""
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30)))


def codec_phase(np, torch, bank, work: str, device: str = "cuda",
                seconds: float = CLI_SECONDS, small: bool = False,
                host_builds: dict = None) -> dict:
    """Phase 11: the codecs' path to the card.  11a the tiers (the native
    pcm / flac / vorbis libraries must have built: ``host_builds`` is phase
    2's ``wavio.warm_native()``, run here when None); 11b a ``seconds`` stereo clip
    as FLAC, Ogg and MP3 through ``cli.render`` on the card into .flac, .ogg
    (and .mp3 / .m4a); 11c ``cli.render_dir`` over a mixed directory with a
    corrupt FLAC, and ``cli.render`` on a truncated one; 11d the HTTP job API
    with FLAC and Ogg uploads and results; 11e ``tools.bench_codecs`` and the
    fuzz ``codec`` / ``encode`` modes.  Returns the tiers, the walls, the
    bank calls (counted before the holds) and the bank's worst errors against
    its plain version over every (shape, batch) the phase called it with."""
    import importlib.util

    from audio_raytracing_studio_tpu_torch import RenderParams, config
    from audio_raytracing_studio_tpu_torch.cli import analyzer, render, render_dir
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import binaural
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.serving import RenderService
    from audio_raytracing_studio_tpu_torch.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu_torch.tools import bench_codecs, fuzz_campaign
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips
    from audio_raytracing_studio_tpu_torch.utils import (_native_flac, _native_lavc,
                                                         _native_pcm, _native_vorbis, kernels,
                                                         lavcio, mp3io, wavio)
    from audio_raytracing_studio_tpu_torch.utils.runtime import ensure_device

    dev = ensure_device(device)
    on_card = dev.type == "cuda"
    path = lambda name: os.path.join(work, name)  # noqa: E731
    out = {"walls_s": {}, "launches": 0, "checks": {}}
    walls, checks = out["walls_s"], out["checks"]

    def timed(label, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        walls[label] = time.perf_counter() - t0
        return result

    def cli(label, main, argv, launches):
        before = bank.launch_count
        stdout, wall = run_cli(main, [*argv, "--device", device])
        launched = bank.launch_count - before
        expected = launches if on_card else 0  # the plain version is not counted
        check(launched == expected, f"{label}: {launched} bank launches, expected {expected}")
        walls[label] = wall
        return stdout

    # ---------------- 11a: the tiers ----------------
    tiers = {}
    warm = host_builds if host_builds is not None else wavio.warm_native()
    builds = {name: w["s"] for name, w in warm.items()}
    for name, mod in (("pcm", _native_pcm), ("flac", _native_flac), ("vorbis", _native_vorbis)):
        mod.lib()  # raises the compiler's message: a failed build fails the phase
        tiers[f"native_{name}"] = mod.available()
    tiers.update(mpg123=mp3io.decode_available(), lame=mp3io.encode_available(),
                 lavc=lavcio.decode_available(),
                 soundfile=importlib.util.find_spec("soundfile") is not None,
                 ffmpeg=shutil.which("ffmpeg") is not None)
    tiers["ogg_decoder"] = "lavc" if tiers["lavc"] else "vorbisio"
    if not tiers["lavc"]:
        # the shim's failed build is remembered: a later process (each CLI
        # call, each server start) reads the marker instead of running g++
        t0 = time.perf_counter()
        try:
            kernels.build_host("lavc_shim", _native_lavc.LINK)
        except RuntimeError as e:
            check("an earlier build failed" in str(e), f"11a: lavc shim retried g++: {e}")
            builds["lavc_marker"] = time.perf_counter() - t0
        # else it built and only its load failed: there is no marker to read
    out["tiers"], out["builds_s"] = tiers, builds
    contracts = []
    probe_wav = path("contract.wav")
    wavio.write(probe_wav, np.zeros((480, 2), np.float32), RATE)
    if not tiers["ffmpeg"]:
        # an absent library gives the JAX package's error, not a crash
        for ok, ext in ((tiers["lame"], ".mp3"), (tiers["lavc"], ".m4a")):
            if ok:
                continue
            try:
                analyzer.convert(probe_wav, path("contract" + ext), device=device)
            except RuntimeError as e:
                check(str(e) == "ffmpeg not found — non-WAV conversion needs ffmpeg on PATH",
                      f"11a: convert to {ext} without its library: {e}")
                contracts.append(f"convert {ext}")
            else:
                raise SmokeFailure(f"11a: convert to {ext} succeeded without its library")
        if not tiers["lame"]:
            try:
                wavio.write_audio(path("contract.mp3"), np.zeros((480, 2), np.float32), RATE)
            except RuntimeError as e:
                check(str(e).startswith("libmp3lame nicht verfügbar"), f"11a: mp3 write: {e}")
                contracts.append("write .mp3")
            else:
                raise SmokeFailure("11a: an MP3 was written without libmp3lame")
    out["contracts"] = contracts
    print(f"[11a tiers] {json.dumps(tiers)}; host library builds and the shim's "
          f"marker (s) {json.dumps(builds)}; "
          f"absent-library contracts checked: {contracts or 'none needed'}", flush=True)

    with BankRecorder(bank) as recorder:
        bank.launch_count = 0
        # ---------------- 11b: one clip through the codecs and cli.render ----------------
        clip = bench_clips(2, seconds)
        song = np.stack([clip[0], 0.8 * clip[1]], axis=1)
        n = song.shape[0]
        inputs = ["flac", "ogg"] + (["mp3"] if tiers["lame"] else [])
        decoded = {}
        for codec in inputs:
            timed(f"encode_in_{codec}", wavio.write_audio, path(f"in.{codec}"), song, RATE)
            data, rate = timed(f"decode_in_{codec}", wavio.read, path(f"in.{codec}"))
            check(rate == RATE and data.shape == song.shape,
                  f"11b: {codec} input decodes to {data.shape} at {rate}")
            decoded[codec] = data
        check(np.array_equal(decoded["flac"], wavio.decode_pcm16(wavio.encode_pcm16(song))),
              "11b: the FLAC input does not decode to its PCM16")
        # the JAX suites' bounds: Vorbis 28 dB (tests/test_vorbisenc.py:141, default
        # quality), MP3 25 dB (tests/test_mp3io.py:67, 256 kbps), AAC 15 dB at the
        # best alignment (tests/test_lavcio.py:68, 192 kbps, lag 0 in MP4)
        bounds = {"ogg": 28.0, "mp3": 25.0, "m4a": 15.0}
        input_snr = {c: snr_db(np, song, decoded[c]) for c in inputs if c != "flac"}
        for codec, snr in input_snr.items():
            check(snr >= bounds[codec], f"11b: {codec} input SNR {snr:.1f} < {bounds[codec]} dB")
        layout = "5.1 (Standard)"
        flags = ["--hall", "Cathedral", "--room-size", "300", "--layout", layout, "--json",
                 "--seed", "3"]
        p = RenderParams(hall_type="Cathedral", room_size=300.0, target_layout=layout)
        renders = {}
        for codec in inputs:
            before = bank.launch_count
            ref = timed(f"render_{codec}", pipeline.render, decoded[codec], RATE, p, seed=3,
                        device=dev)
            check(bank.launch_count - before == (1 if on_card else 0),
                  f"11b: render of the {codec} input: {bank.launch_count - before} launches")
            cpu = pipeline.render(decoded[codec], RATE, p, seed=3, device="cpu")
            err = float(np.abs(ref - cpu).max())
            check(err <= CARD_CPU_TOL, f"11b: {codec} input card vs CPU {err} > {CARD_CPU_TOL}")
            clipped = np.clip(ref, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
            q = wavio.encode_pcm16(clipped)
            res = {"card_vs_cpu": err}
            targets = ["flac", "ogg"]
            if codec == "flac":
                targets += (["mp3"] if tiers["lame"] else []) + (["m4a"] if tiers["lavc"] else [])
            for ext in targets:
                target = path(f"out_{codec}.{ext}")
                argv = [path(f"in.{codec}"), target, *flags]
                if ext == "mp3":
                    argv.append("--binaural")  # MP3 carries at most two channels
                cli(f"cli {codec}->{ext}", render.main, argv, 1)
                back, r = timed(f"decode_out_{codec}_{ext}", wavio.read, target)
                check(r == RATE, f"11b: {target} at {r} Hz")
                if ext == "flac":
                    lsb = int(np.abs(np.rint(back * 32768.0).astype(np.int32)
                                     - q.astype(np.int32)).max())
                    check(back.shape == ref.shape and lsb <= 1,
                          f"11b: {target} {back.shape} vs {ref.shape}, {lsb} LSB")
                    res["flac_lsb"] = lsb
                elif ext == "ogg":
                    check(back.shape == ref.shape, f"11b: {target} {back.shape} vs {ref.shape}")
                    res["ogg_snr_db"] = snr_db(np, clipped, back)
                elif ext == "mp3":
                    stereo = np.clip(binaural.binauralize(ref, RATE, layout, device=dev),
                                     -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
                    check(back.shape == stereo.shape,
                          f"11b: {target} {back.shape} vs {stereo.shape}")
                    res["mp3_snr_db"] = snr_db(np, stereo, back)
                else:
                    check(ref.shape[0] <= back.shape[0] <= ref.shape[0] + 1024
                          and back.shape[1] == ref.shape[1],
                          f"11b: {target} {back.shape} vs {ref.shape} (+ ≤ 1024 frames)")
                    res["m4a_snr_db"] = snr_db(np, clipped, back[:ref.shape[0]])
                for key, ext_key in (("ogg_snr_db", "ogg"), ("mp3_snr_db", "mp3"),
                                     ("m4a_snr_db", "m4a")):
                    if ext == ext_key:
                        check(res[key] >= bounds[ext],
                              f"11b: {target} SNR {res[key]:.1f} < {bounds[ext]} dB")
            renders[codec] = res
        checks["11b"] = {"input_snr_db": input_snr, "renders": renders}
        print(f"[11b render] {seconds:g} s stereo clip as {inputs} -> cli.render Cathedral 300 "
              f"5.1 on {dev} -> flac/ogg (+ mp3 binaural, m4a from the FLAC input): "
              f"{json.dumps(checks['11b'])} (card vs CPU tol {CARD_CPU_TOL}; FLAC 1 LSB; "
              f"SNR bounds {bounds} dB)", flush=True)

        # ---------------- 11c: render_dir over a mixed directory ----------------
        d_in, d_out = path("dir_in"), path("dir_out")
        os.makedirs(d_in)
        lengths = (seconds / 3.0 - 0.3, seconds / 2.4 - 0.3)  # two half-second buckets
        names = ["a.wav", "b.flac", "c.ogg", "d.aiff", "e.wav", "f.flac", "g.ogg"]
        names += (["h.mp3"] if tiers["lame"] else []) + (["i.m4a"] if tiers["lavc"] else [])
        for k, name in enumerate(names):
            m = int(lengths[k % 2] * RATE)
            x = clip[k % 2, :m]
            x = x[:, None] if k % 3 == 0 else np.stack([x, 0.7 * x[::-1]], axis=1)
            if name.endswith(".aiff"):
                with open(os.path.join(d_in, name), "wb") as f:
                    f.write(fuzz_campaign._aiff_bytes(x, RATE))
            else:
                wavio.write_audio(os.path.join(d_in, name), x, RATE)
        with open(path("in.flac"), "rb") as f:
            head = f.read(20)
        with open(os.path.join(d_in, "corrupt.flac"), "wb") as f:
            f.write(head)  # STREAMINFO cut short
        schedule = {}
        for name in names:
            meta = wavio.probe(os.path.join(d_in, name))
            key = sharding.bucket_length(meta["frames"], meta["samplerate"])
            schedule[key] = schedule.get(key, 0) + 1
        micro = sum(-(-count // 4) for count in schedule.values())
        err_buf = io.StringIO()
        with contextlib.redirect_stderr(err_buf):
            stdout = cli("render_dir", render_dir.main,
                         [d_in, d_out, "--batch", "4", "--layout", "Stereo", "--metrics",
                          "--json"], micro)
        result = json.loads(stdout)
        check("skipping corrupt.flac: truncated FLAC metadata" in err_buf.getvalue(),
              f"11c: the corrupt FLAC was not reported: {err_buf.getvalue()!r}")
        kept = {".wav": ".wav", ".flac": ".flac", ".ogg": ".ogg"}
        outputs = sorted(os.listdir(d_out))
        want = sorted(os.path.splitext(nm)[0] + kept.get(os.path.splitext(nm)[1], ".wav")
                      for nm in names)
        check(outputs == want and len(result["clips"]) == len(names),
              f"11c: outputs {outputs}, expected {want}")
        for name in names:
            x, _ = wavio.read(os.path.join(d_in, name))
            stem, ext = os.path.splitext(name)
            y, r = wavio.read(os.path.join(d_out, stem + kept.get(ext, ".wav")))
            ir_len = pipeline.build_internal_spec(RenderParams(target_layout="Stereo"), RATE,
                                                  x.shape[0])[0].len_out
            check(r == RATE and y.shape == (ir_len, 2) and np.all(np.isfinite(y))
                  and np.abs(y).max() > 0, f"11c: {name} -> {y.shape} at {r} (want {ir_len})")
        # a FLAC truncated mid-stream: the JAX package's German message, exit 1
        with open(path("in.flac"), "rb") as f:
            blob = f.read()
        with open(path("cut.flac"), "wb") as f:
            f.write(blob[:len(blob) // 2])
        err_buf = io.StringIO()
        with contextlib.redirect_stderr(err_buf), contextlib.redirect_stdout(io.StringIO()):
            rc = render.main([path("cut.flac"), path("cut_out.wav"), "--device", device])
        check(rc == 1 and f"error: cannot read {path('cut.flac')}: FLAC-Datei beschädigt oder "
              "abgeschnitten: " in err_buf.getvalue(), f"11c: truncated FLAC: {rc} "
              f"{err_buf.getvalue()!r}")
        checks["11c"] = {"files": names, "micro_batches": micro,
                         "audio_seconds": result["audio_seconds"]}
        print(f"[11c render_dir] {len(names)} files {names} + corrupt.flac in {micro} "
              f"micro-batches: every good file rendered (true + IR - 1, .flac/.ogg kept), "
              f"corrupt.flac skipped with 'truncated FLAC metadata'; cli.render on a FLAC cut "
              f"mid-stream exits 1 with 'FLAC-Datei beschädigt oder abgeschnitten'", flush=True)

        # ---------------- 11d: the HTTP job API with FLAC and Ogg ----------------
        svc = RenderService(max_batch=4, max_wait_ms=50, pcm16_output=True, device=dev)
        http = RenderHTTPService(svc, host="127.0.0.1", port=0).start()
        t0 = time.perf_counter()
        try:
            m = int(min(10.0, seconds / 2) * RATE)
            ups = {}
            for codec in ("flac", "ogg"):
                src = path(f"up.{codec}")
                wavio.write_audio(src, song[:m], RATE)
                with open(src, "rb") as f:
                    code, body = http_call(http.port, "POST", "/v1/upload", f.read(),
                                           {"X-Filename": f"up.{codec}"})
                check(code == 200, f"11d: upload {codec} answered {code}")
                ups[codec] = (json.loads(body)["path"], wavio.read(src)[0].shape[0])
            params = {"target_layout": "Stereo", "diffusion": 0.6}
            code, body = http_call(http.port, "POST", "/v1/jobs", json.dumps(
                {"input": ups["flac"][0], "format": "mp3"}).encode())
            check(code == 400 and json.loads(body)["error"]
                  == "unknown format 'mp3' (use wav/flac/ogg)", f"11d: mp3 job: {code} {body}")
            jobs = []
            for codec, fmt in (("flac", "flac"), ("flac", "wav"), ("ogg", "ogg"), ("ogg", "flac")):
                code, body = http_call(http.port, "POST", "/v1/jobs", json.dumps(
                    {"input": ups[codec][0], "format": fmt, "seed": 5,
                     "params": params}).encode())
                check(code == 202, f"11d: {codec} -> {fmt} job answered {code}: {body[:200]}")
                jobs.append((codec, fmt, json.loads(body)["job_id"]))
            results = {}
            deadline = time.monotonic() + 300
            for codec, fmt, jid in jobs:
                while True:
                    st = json.loads(http_call(http.port, "GET", f"/v1/jobs/{jid}")[1])
                    if st["status"] != "queued":
                        break
                    check(time.monotonic() < deadline, f"11d: job {jid} still queued")
                    time.sleep(0.02)
                check(st["status"] == "done", f"11d: {codec} -> {fmt} ended {st}")
                code, blob = http_call(http.port, "GET", f"/v1/jobs/{jid}/result")
                check(code == 200, f"11d: result of {codec} -> {fmt} answered {code}")
                target = path(f"served_{codec}.{fmt}")
                with open(target, "wb") as f:
                    f.write(blob)
                y, r = wavio.read(target)
                want_len = pipeline.build_internal_spec(
                    RenderParams(**params), RATE, ups[codec][1])[0].len_out
                check(r == RATE and y.shape == (want_len, 2) and np.abs(y).max() > 0,
                      f"11d: {codec} -> {fmt}: {y.shape} at {r}, want {want_len} frames")
                results[(codec, fmt)] = y
            check(np.array_equal(results[("flac", "flac")], results[("flac", "wav")]),
                  "11d: the FLAC result differs from the WAV result of the same job")
            served_snr = snr_db(np, results[("ogg", "flac")], results[("ogg", "ogg")])
            check(served_snr >= bounds["ogg"], f"11d: served Ogg SNR {served_snr:.1f}")
        finally:
            http.stop()
        walls["http"] = time.perf_counter() - t0
        checks["11d"] = {"served_ogg_snr_db": served_snr}
        print(f"[11d http] FLAC and Ogg uploads ({m / RATE:g} s); flac, wav, ogg results "
              f"decoded at their true length and not silent, the FLAC result = the WAV "
              f"result, the Ogg result {served_snr:.1f} dB against the FLAC one; 'mp3' "
              f"answered 400", flush=True)
        out["launches"] = bank.launch_count

        # ---------------- 11e: bench_codecs and the codec fuzz modes ----------------
        rc, lines, wall = run_tool(bench_codecs.main, ["--lengths", f"{seconds:g}",
                                                       "--device", device])
        check(rc == 0 and lines, f"11e bench_codecs: exit {rc}")
        walls["bench_codecs"] = wall
        for obj in lines:
            print("[11e bench_codecs] " + json.dumps(obj), flush=True)
            check(obj["host_only"] is True, f"11e: {obj}")
            if obj["codec"] == "pcm16":
                check(obj.get("bit_equal") is True, f"11e: native PCM16 vs NumPy: {obj}")
            elif obj["available"]:
                check(obj["encode_x_rt"] > 0 and obj["decode_x_rt"] > 0, f"11e: {obj}")
        out["bench_codecs"] = lines
        for mode in ("codec", "encode"):
            rc, lines, wall = run_tool(fuzz_campaign.main, [
                mode, "3" if small else "12", "--device", device,
                "--findings", path(f"fuzz_{mode}.jsonl")])
            check(rc == 0 and lines and lines[-1]["findings"] == 0,
                  f"11e fuzz {mode}: exit {rc}, {lines[-1:]}")
            walls[f"fuzz_{mode}"] = wall
            print(f"[11e fuzz {mode}] " + json.dumps(lines[-1]), flush=True)
    out["bank_errs"] = recorder.hold(torch) if on_card else [0.0, 0.0]
    out["held"] = {"hash": len(recorder.hash), "injected": len(recorder.injected)}
    return out


def gaps(got: list, want: list) -> float:
    """The largest |Δ| of any metric over two lists of per-clip metric dicts
    (equal infinities count as 0)."""
    return max((0.0 if float(g[k]) == float(w[k]) else abs(float(g[k]) - float(w[k])))
               for g, w in zip(got, want) for k in g)


def mesh_phase(np, torch, bank, work: str, device: str = "cuda", batch: int = BATCH,
               seconds: float = DURATION_S, long_seconds: float = LONG_MESH_S,
               small: bool = False) -> dict:
    """Phase 12: the device mesh, one card standing in for N devices
    (``make_mesh(devices=["cuda:0"] * N)``; N shards of one card are not N
    cards).  12a the data-parallel ``render_batch`` over data=4 against the
    meshless one (fast, exact, then metered + PCM16 + padded EQ-on clips);
    12b ``render_long`` at block 8 and 4 (5.1) and block 4 (7.1) against the
    single-shot exact ``render`` and the single-device meter; 12c
    ``partitioned_convolve`` at block 4 against ``convolve_full``; 12d
    ``RenderService(device_mesh=...)`` on a burst, each job against its row of
    the direct mesh render, then ``bench_serving --matrix`` with its mesh
    arms; 12e ``graft_entry.dryrun_multichip(8)`` and the two-process
    ``tools.dryrun_distributed``.  ``small`` shrinks the tool runs for the
    CPU rehearsal.  Returns the timings, the bank calls counted over the
    phase (before the holds, which do not count) and the bank's worst error
    against its plain version over every (shape, batch) the phase called it
    with."""
    from audio_raytracing_studio_tpu_torch import RenderParams, graft_entry
    from audio_raytracing_studio_tpu_torch.metering import loudness
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import convolution, ir_synth
    from audio_raytracing_studio_tpu_torch.parallel import long_render, mesh, partitioned_conv
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService
    from audio_raytracing_studio_tpu_torch.tools import bench_serving
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    shard_dev = "cuda:0" if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def mesh_of(data=1, block=1):
        return mesh.make_mesh(data=data, block=block, devices=[shard_dev] * (data * block))

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        return result, time.perf_counter() - t0

    print(f"[12 mesh] one {'card' if on_card else 'CPU'} stands in for N devices: "
          f"make_mesh(devices=[{shard_dev!r}] * N); N shards of one card are not N cards, "
          "so no time here is a multi-card time", flush=True)
    timing = {"shards": MESH_SHARDS}
    walls = {}
    t_phase = time.perf_counter()
    with BankRecorder(bank) as recorder:
        # ---------------- 12a: the data-parallel batch ----------------
        t_step = time.perf_counter()
        clips = bench_clips(batch, seconds)
        data_mesh = mesh_of(data=MESH_SHARDS)
        p = RenderParams(target_layout="Stereo")
        for fast in (True, False):
            mode = "fast" if fast else "exact"
            kw = dict(fast_filters=fast, device=dev)
            # in turns: meshless, mesh, mesh, meshless, meshless — the first
            # call on each side pays its plans, and the caching allocator
            # reuses a block only on the stream it was made for, so the first
            # meshless call after the mesh's (shard streams) pays fresh
            # device memory again
            want, w1 = timed(lambda: sharding.render_batch(clips, RATE, p, **kw))
            before = bank.launch_count
            got, m1 = timed(lambda: sharding.render_batch(clips, RATE, p, device_mesh=data_mesh,
                                                          **kw))
            check(not on_card or bank.launch_count == before + MESH_SHARDS,
                  f"12a {mode}: {bank.launch_count - before} bank calls for {MESH_SHARDS} shards")
            err = float(np.abs(got - want).max())
            check(got.shape == want.shape and err <= MESH_TOL,
                  f"12a {mode}: mesh vs meshless {got.shape} {want.shape} max-abs {err}")
            del got
            _, m2 = timed(lambda: sharding.render_batch(clips, RATE, p, device_mesh=data_mesh,
                                                        **kw))
            _, w2 = timed(lambda: sharding.render_batch(clips, RATE, p, **kw))
            _, w3 = timed(lambda: sharding.render_batch(clips, RATE, p, **kw))
            del want
            timing[f"12a_{mode}"] = {"max_abs": err, "mesh_s": [m1, m2],
                                     "meshless_s": [w1, w2, w3]}
            print(f"[12a data-parallel] {mode}: B={batch} x {seconds:g} s over data="
                  f"{MESH_SHARDS}: mesh vs meshless max-abs {err:.3e} (tol {MESH_TOL}); "
                  f"walls in turns meshless {w1:.3f}, mesh {m1:.3f} / {m2:.3f}, meshless "
                  f"{w2:.3f} / {w3:.3f} s", flush=True)
        n_in = clips.shape[1]
        lengths = [n_in - int(0.2 * n_in * b / (batch - 1)) for b in range(batch)]
        padded = clips.copy()
        for b, tl in enumerate(lengths):
            padded[b, tl:] = 0.0
        p_eq = RenderParams(target_layout="Stereo", bass_gain=1.6, treble_gain=0.7)
        kw = dict(with_metrics=True, pcm16_output=True, clip_lengths=lengths, device=dev)
        # in turns: meshless, mesh, meshless
        (want_q, want_m), w1 = timed(lambda: sharding.render_batch(padded, RATE, p_eq, **kw))
        (q, metrics), m1 = timed(lambda: sharding.render_batch(padded, RATE, p_eq,
                                                               device_mesh=data_mesh, **kw))
        _, w2 = timed(lambda: sharding.render_batch(padded, RATE, p_eq, **kw))
        lsb = int(np.abs(q.astype(np.int32) - want_q.astype(np.int32)).max())
        mgap = gaps(metrics, want_m)
        check(q.dtype == np.int16 and q.shape == want_q.shape and lsb <= 1,
              f"12a metered: PCM16 {q.dtype} {q.shape} differs by {lsb} LSB")
        check(mgap <= MESH_METRIC_TOL, f"12a metered: metrics differ by {mgap}")
        del q, want_q
        timing["12a_metered"] = {"lsb": lsb, "metrics_gap": mgap, "mesh_s": m1,
                                 "meshless_s": [w1, w2]}
        print(f"[12a data-parallel] metered + PCM16 + padded EQ (bass 1.6, treble 0.7): "
              f"{lsb} LSB, metrics within {mgap:.2e} (tol 1 LSB, {MESH_METRIC_TOL}); walls in "
              f"turns meshless {w1:.3f}, mesh {m1:.3f}, meshless {w2:.3f} s", flush=True)
        walls["12a"] = time.perf_counter() - t_step

        # ---------------- 12b: the sequence-parallel long render ----------------
        t_step = time.perf_counter()
        rng = np.random.default_rng(3)
        t = np.arange(int(long_seconds * RATE)) / RATE
        x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t))
             ).astype(np.float32)
        singles = {}
        for label, layout, blocks in (("5.1 block 8", "5.1 (Standard)", 8),
                                      ("5.1 block 4", "5.1 (Standard)", 4),
                                      ("7.1 block 4", "7.1 (Surround)", 4)):
            p_long = RenderParams(target_layout=layout, room_size=120.0, bass_gain=1.6,
                                  treble_gain=0.7)
            if layout not in singles:
                singles[layout] = timed(lambda: pipeline.render(
                    x, RATE, p_long, seed=3, fast_filters=False, device=dev))
            exact, single_s = singles[layout]
            block_mesh = mesh_of(block=blocks)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            (out, met), wall = timed(lambda: long_render.render_long(
                x, RATE, p_long, block_mesh, seed=3, with_metrics=True))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
            _, again = timed(lambda: long_render.render_long(x, RATE, p_long, block_mesh,
                                                             seed=3, with_metrics=True))
            err = float(np.abs(out - exact).max())
            check(out.shape == exact.shape and err <= LONG_TOL,
                  f"12b {label}: {out.shape} vs {exact.shape}, max-abs {err} > {LONG_TOL}")
            ref = loudness.audio_metrics(torch.from_numpy(np.ascontiguousarray(out.T)).to(dev),
                                         RATE)
            ref = {k: float(v) for k, v in ref.items()}
            d = [abs(met[k] - ref[k]) if met[k] != ref[k] else 0.0
                 for k in ("lufs", "true_peak_dbfs", "rms_dbfs")]
            check(d[0] <= LONG_LU_TOL and max(d[1:]) <= LONG_DB_TOL,
                  f"12b {label}: sharded meter {met} vs single-device {ref}")
            timing[f"12b_{label}"] = {"max_abs": err, "metrics_gap": d, "wall_s": [wall, again],
                                      "single_shot_s": single_s, "peak_gb": peak_gb,
                                      "len_out": out.shape[0]}
            print(f"[12b long] {label}: {out.shape} vs single-shot exact max-abs {err:.3e} "
                  f"(tol {LONG_TOL}); meter d lufs {d[0]:.2e} LU, peak {d[1]:.2e}, rms "
                  f"{d[2]:.2e} dB; walls {wall:.3f} / {again:.3f} s (single-shot "
                  f"{single_s:.3f} s); peak allocated {peak_gb} GB — every shard on this "
                  "one device", flush=True)
            del out
        del singles
        walls["12b"] = time.perf_counter() - t_step

        # ---------------- 12c: the partitioned convolution ----------------
        t_step = time.perf_counter()
        setup = pipeline.build_internal_setup(p, RATE, n_in)
        seeds_t = ir_synth.to_device(ir_synth.seeds_to_int32([7]), dev)
        early, late = bank.fused_rir_bank(seeds_t, setup.ir_shape, setup.ir_scalars)
        ker = torch.cat([early, late])  # (2, L): the main path's IR pair
        n_sig = setup.spec.len_out
        sig = np.zeros((2, n_sig), np.float32)
        sig[:, :n_in] = clips[:2]
        block_mesh = mesh_of(block=4)
        n_pad = partitioned_conv.padded_length(n_sig, ker.shape[1], 4)
        sig_pad = np.pad(sig, ((0, 0), (0, n_pad - n_sig)))
        conv, part_s = timed(lambda: partitioned_conv.partitioned_convolve(sig_pad, ker,
                                                                            block_mesh))
        _, part2_s = timed(lambda: partitioned_conv.partitioned_convolve(sig_pad, ker,
                                                                          block_mesh))
        n_lin = n_sig + ker.shape[1] - 1
        sig_t = torch.from_numpy(sig).to(dev)
        ref, full_s = timed(lambda: convolution.convolve_full(sig_t[None], ker[None], n_lin)[0])
        peak = ref.abs().max().item()
        rel = (conv[..., :n_lin] - ref).abs().max().item() / peak
        check(tuple(conv.shape) == (2, 2, n_pad) and rel <= CONV_TOL,
              f"12c: partitioned vs convolve_full {tuple(conv.shape)} relative max-abs {rel}")
        timing["12c"] = {"relative_max_abs": rel, "partitioned_s": [part_s, part2_s],
                         "convolve_full_s": full_s, "n": n_sig, "l": int(ker.shape[1])}
        print(f"[12c partitioned] (2, {n_sig}) ⊛ (2, {ker.shape[1]}) at block 4: relative "
              f"max-abs {rel:.3e} of peak {peak:.3f} (tol {CONV_TOL}); walls {part_s:.3f} / "
              f"{part2_s:.3f} s, convolve_full {full_s:.3f} s", flush=True)
        del conv, ref, sig_t
        walls["12c"] = time.perf_counter() - t_step

        # ---------------- 12d: serving over the mesh ----------------
        t_step = time.perf_counter()
        params = [RenderParams(target_layout="Stereo", diffusion=0.2 + 0.6 * i / (batch - 1),
                               x_pos=i / (batch - 1)) for i in range(batch)]
        seeds = [2000 + 11 * i for i in range(batch)]
        n_bucket = sharding.bucket_length(n_in, RATE)
        job_lens = [n_in - 97 * i for i in range(batch)]
        staged = np.zeros((batch, n_bucket), np.float32)
        for i, n in enumerate(job_lens):
            staged[i, :n] = clips[i, :n]
        direct_q, direct_m = sharding.render_batch(
            staged, RATE, params, seeds=seeds, with_metrics=True, clip_lengths=job_lens,
            pcm16_output=True, device_mesh=data_mesh, device=dev)
        svc = RenderService(device_mesh=data_mesh, max_batch=batch, max_wait_ms=2000,
                            pcm16_output=True, max_queued=2 * batch, device=dev)
        try:
            jobs = [RenderJob(clips[i, :job_lens[i]], RATE, params[i], seed=seeds[i],
                              with_metrics=True) for i in range(batch)]
            wait_all([svc.submit(j) for j in jobs])  # the warm burst
            sync()
            t0 = time.perf_counter()
            results = wait_all([svc.submit(j) for j in jobs])
            burst_s = time.perf_counter() - t0
            st = svc.stats()
        finally:
            svc.stop()
        check(st["batch_sizes"] == [batch, batch] and st["jobs_failed"] == 0,
              f"12d: batches {st['batch_sizes']}, {st['jobs_failed']} failed")
        tail = direct_q.shape[1] - n_bucket
        for i, r in enumerate(results):
            real = job_lens[i] + tail
            check(np.array_equal(r.audio, direct_q[i, :real]) and r.metrics == direct_m[i],
                  f"12d: job {i} differs from its row of the direct mesh render_batch")
        del results, direct_q
        timing["12d"] = {"burst_s": burst_s, "audio_s_per_s": sum(job_lens) / RATE / burst_s,
                         "dispatch_s": st["dispatch_s"], "fetch_s": st["fetch_s"]}
        print(f"[12d serving] RenderService(device_mesh=data {MESH_SHARDS}): {batch} jobs, each "
              f"bit-equal to its row of the direct mesh render_batch; burst {burst_s:.3f} s "
              f"({timing['12d']['audio_s_per_s']:.0f} audio-s/s)", flush=True)
        argv = ["--matrix", "--soak", "2" if small else "5", "--mesh-devices", str(MESH_SHARDS),
                "--warm-buckets", "2", "--device", device]
        argv += (["--jobs", "4", "--seconds", "0.5", "--rate", "16000", "--soak-durations",
                  "0.3,0.7", "--arrival-rate", "4"] if small else ["--soak-durations", "5.3,14.7"])
        rc, printed, matrix_s = run_tool(bench_serving.main, argv)
        check(rc == 0 and printed, f"12d matrix: exit {rc}")
        for obj in printed:
            print("[12d matrix] " + json.dumps(obj), flush=True)
        arms = {a["arm"]: a for a in printed[-1]["arms"]}
        check(set(arms) == {"bank+extir", "jnp", "mesh", "bank-mesh"}
              and all(a["failed"] == 0 and a["completed"] > 0 for a in arms.values()),
              f"12d matrix: arms {arms}")
        timing["12d"]["matrix_s"] = matrix_s
        walls["12d"] = time.perf_counter() - t_step

        # ---------------- 12e: the dry runs ----------------
        t_step = time.perf_counter()
        report, dry_s = timed(lambda: graft_entry.dryrun_multichip(8, devices=[shard_dev] * 8))
        print(f"[12e dryrun_multichip] {json.dumps(report)} in {dry_s:.2f} s", flush=True)
        free_gb = None
        if on_card:
            # the two processes need card memory of their own: hand back what
            # this process keeps cached after phases 4-12 (the allocator's
            # blocks, the cuFFT plans beside it) — a full run left too little
            sync()
            torch.backends.cuda.cufft_plan_cache.clear()
            torch.cuda.empty_cache()
            free_gb = torch.cuda.mem_get_info()[0] / 1e9
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "audio_raytracing_studio_tpu_torch.tools.dryrun_distributed",
             "--device", device, "--timeout", "240"],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        two_s = time.perf_counter() - t0
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        check(proc.returncode == 0 and lines and lines[-1]["ok"] is True
              and lines[-1]["out_shape"][0] == lines[-1]["batch"],
              f"12e dryrun_distributed: rc {proc.returncode} {proc.stdout[-500:]} "
              f"{proc.stderr[-2000:]}")
        print(f"[12e dryrun_distributed] {json.dumps(lines[-1])} in {two_s:.2f} s "
              f"({free_gb} GB of the card free when it started)", flush=True)
        timing["12e"] = {"dryrun_multichip_s": dry_s, "dryrun_distributed_s": two_s,
                         "free_gb_before": free_gb}
        walls["12e"] = time.perf_counter() - t_step
    launches = bank.launch_count
    errs = recorder.hold(torch) if on_card else [0.0, 0.0]
    timing["walls_s"] = walls
    timing["phase_s"] = time.perf_counter() - t_phase
    return {"timing": timing, "launches": launches, "bank_errs": errs,
            "held": {"hash": len(recorder.hash), "injected": len(recorder.injected)}}


def rehearse_cpu(seconds: float) -> int:
    """``--rehearse-cpu SECONDS``: phases 4c, 8, 9, 10, 11 and 12's control flow
    on the CPU at a short clip length (4c's batch is 4 clips of SECONDS; phase
    9's 30-minute clip becomes SECONDS
    long, every other length in proportion; phase 10's tools run at their tiny
    sizes, phase 11's clip is SECONDS long, phase 12 runs 8 clips and its long
    render at SECONDS on meshes of ``["cpu"] * N``), with the kernels' plain
    versions.  It measures nothing
    and prints no result line; it exists to find wrong paths, shapes and
    names before a run on the card."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from audio_raytracing_studio_tpu_torch.metering import loudness
    from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips

    metered = metered_batch_phase(np, torch, sharding, loudness, bank, bench_clips(4, seconds),
                                  device="cpu")
    print("[4c rehearsal on the CPU: no device number] " + json.dumps(metered))
    work = tempfile.mkdtemp(prefix="chip_smoke_product_")
    try:
        product = product_phase(np, torch, bank, work, seconds=seconds, device="cpu")
        print("[8 rehearsal on the CPU: no device number] " + json.dumps(product["timing"]))
        long_clips = streaming_phase(np, torch, bank, work, minutes=seconds / 60.0, device="cpu")
        print("[9 rehearsal on the CPU: no device number] " + json.dumps(long_clips["timing"]))
        tools = tooling_phase(np, torch, bank, work, {}, device="cpu", small=True)
        print("[10 rehearsal on the CPU: no device number] " + json.dumps(tools["walls_s"]))
        codec_work = os.path.join(work, "codecs")
        os.makedirs(codec_work)
        codecs = codec_phase(np, torch, bank, codec_work, device="cpu", seconds=seconds,
                             small=True)
        print("[11 rehearsal on the CPU: no device number] " + json.dumps(codecs["walls_s"]))
        meshed = mesh_phase(np, torch, bank, work, device="cpu", batch=2 * MESH_SHARDS,
                            seconds=seconds, long_seconds=seconds, small=True)
        print("[12 rehearsal on the CPU: no device number] "
              + json.dumps(meshed["timing"]["walls_s"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / CUDA port on one GPU; "
                                 "with no arguments every phase runs and the result lines print.")
    ap.add_argument("--only", choices=["8", "9", "10", "11", "12", "13"], default=None,
                    help="development: phases 1, 2 and this one; prints no result line")
    ap.add_argument("--rehearse-cpu", type=float, default=None, metavar="SECONDS",
                    help="development: phases 4c, 8, 9, 10, 11 and 12's control flow on "
                         "the CPU at this clip length")
    args = ap.parse_args(argv)
    if args.rehearse_cpu is not None:
        return rehearse_cpu(args.rehearse_cpu)

    # --- 1. environment ---
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.metering import loudness
    from audio_raytracing_studio_tpu_torch.models import pipeline
    from audio_raytracing_studio_tpu_torch.ops import back_half_cuda, ir_synth
    from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips
    from audio_raytracing_studio_tpu_torch.utils import kernels

    # the render path runs no matmul and no cuDNN convolution, phase 6's
    # resample_poly one cuDNN conv1d (which turns TF32 off for itself); pin both off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 still on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 still on")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} card {card!r} nvidia-smi {smi!r} tf32 off",
          flush=True)

    # --- 2. build: nvcc for the kernels, g++ for the codecs' host libraries, at once ---
    from concurrent.futures import ThreadPoolExecutor

    from audio_raytracing_studio_tpu_torch.utils import wavio

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(wavio.warm_native)
        lib = kernels.build("rir_bank")
        bank._launcher(), bank._injected_launcher()  # both symbols bind
        back_lib = kernels.build("back_half")
        back_half_cuda._launchers()  # both symbols bind
        nvcc_s = time.perf_counter() - t0
        host_builds = host.result()
    print(f"[2 build] {os.path.relpath(lib, REPO)} (rir_bank_launch, "
          f"rir_bank_injected_launch), {os.path.relpath(back_lib, REPO)} (back_half_launch, "
          f"back_half_mix_launch) in {nvcc_s:.2f} s; host libraries "
          f"{json.dumps(host_builds)}; both in {time.perf_counter() - t0:.2f} s", flush=True)

    def product():
        """Phase 8 in a temporary directory, its bank calls counted from 0."""
        bank.launch_count = 0
        work = tempfile.mkdtemp(prefix="chip_smoke_product_")
        try:
            result = product_phase(np, torch, bank, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print("[8 timing] " + json.dumps({"card": card, "nvidia_smi": smi, **result["timing"],
                                          "matplotlib": result["matplotlib"],
                                          "pil": result["pil"], "steps": result["steps"]}),
              flush=True)
        return result

    def long_clips():
        """Phase 9 in a temporary directory, its bank calls counted from 0."""
        bank.launch_count = 0
        work = tempfile.mkdtemp(prefix="chip_smoke_streaming_")
        try:
            result = streaming_phase(np, torch, bank, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print("[9 timing] " + json.dumps({"card": card, "nvidia_smi": smi,
                                          "launches": result["launches"], **result["timing"]}),
              flush=True)
        return result

    def tools(rtf):
        """Phase 10 in a temporary directory, its bank calls counted from 0."""
        bank.launch_count = bank.injected_launch_count = 0
        work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
        try:
            result = tooling_phase(np, torch, bank, work, rtf)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print("[10 timing] " + json.dumps({
            "card": card, "nvidia_smi": smi, "walls_s": result["walls_s"],
            "launches": result["launches"], "injected_launches": result["injected_launches"],
            "held": result["held"], "bank_errs": result["bank_errs"]}), flush=True)
        return result

    def codecs():
        """Phase 11 in a temporary directory, its bank calls counted from 0."""
        work = tempfile.mkdtemp(prefix="chip_smoke_codecs_")
        try:
            result = codec_phase(np, torch, bank, work, host_builds=host_builds)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print("[11 timing] " + json.dumps({
            "card": card, "nvidia_smi": smi, "tiers": result["tiers"],
            "builds_s": result["builds_s"], "walls_s": result["walls_s"],
            "launches": result["launches"], "held": result["held"],
            "bank_errs": result["bank_errs"], "checks": result["checks"]}), flush=True)
        return result

    def meshes():
        """Phase 12 in a temporary directory, its bank calls counted from 0."""
        bank.launch_count = bank.injected_launch_count = 0
        work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        try:
            result = mesh_phase(np, torch, bank, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print("[12 timing] " + json.dumps({
            "card": card, "nvidia_smi": smi, **result["timing"],
            "launches": result["launches"], "held": result["held"],
            "bank_errs": result["bank_errs"]}), flush=True)
        return result

    def back_half():
        """Phase 13: the back half's kernels at the cells' shapes."""
        t0, before = time.perf_counter(), back_half_cuda.launch_count
        result = back_half_phase(np, torch, bench_clips(BATCH, DURATION_S))
        print("[13 timing] " + json.dumps({"card": card, "nvidia_smi": smi,
                                           "wall_s": time.perf_counter() - t0,
                                           "launches": back_half_cuda.launch_count - before}),
              flush=True)
        return result

    if args.only is not None:
        {"8": product, "9": long_clips, "10": lambda: tools({}), "11": codecs,
         "12": meshes, "13": back_half}[args.only]()
        print(f"chip_smoke: --only {args.only} ran phases 1, 2 and {args.only}; a partial run "
              "prints no result line")
        return 0

    # --- 3. bank check: kernel vs plain on the card ---
    p = RenderParams(target_layout="Stereo")
    n_in = int(DURATION_S * RATE)
    bench_setup = pipeline.build_internal_setup(p, RATE, n_in)
    cathedral = pipeline.build_internal_setup(
        RenderParams(hall_type="Cathedral", room_size=600.0), RATE, n_in
    )
    # tests/test_pallas_rir.py's wrap regression: the tail starts at sample 1
    # and the length is one whole tile, so the smoothing halo crosses both edges
    split1 = ir_synth.IRShape(length=4096, split_point=1, actual_max_early_delay=1,
                              reflection_count=25, late_length=4095, noise_smooth_width=10,
                              early_taps_active=False)
    bank_err = 0.0
    for label, shape, ir_sc, seeds in (
        ("bench", bench_setup.ir_shape, bench_setup.ir_scalars,
         list(range(BATCH)) + [2**31, 0xFFFFFFFF]),
        ("cathedral", cathedral.ir_shape, cathedral.ir_scalars, [0, 7, 2**31, 0xFFFFFFFF]),
        ("split1", split1, bench_setup.ir_scalars, [2**31 + 5]),
    ):
        errs = hold_bank(np, torch, bank, label, shape, ir_sc, seeds)
        bank_err = max(bank_err, *errs)
        print(f"[3 bank] {label}: B={len(seeds)} length={shape.length} split="
              f"{shape.split_point} tiles="
              f"{bank.n_tiles(shape)} max-abs early {errs[0]:.3e} late {errs[1]:.3e} "
              f"(tol {BANK_TOL})", flush=True)

    # --- 3b. injected bank check: kernel vs plain on the card ---
    injected_err = 0.0
    for label, shape, ir_sc, batch, degenerate in (
        ("bench", bench_setup.ir_shape, bench_setup.ir_scalars, BATCH, ()),
        ("cathedral", cathedral.ir_shape, cathedral.ir_scalars, 4, ()),
        ("split1", split1, bench_setup.ir_scalars, 2, ()),
        ("degenerate", bench_setup.ir_shape, bench_setup.ir_scalars, 3, (1,)),
    ):
        packed = injected_draws(bank, shape, batch, seed=batch, degenerate=degenerate)
        scal = ir_sc.table(batch, "cuda")
        before = bank.injected_launch_count
        *kern, raw_k = bank._rir_bank_cuda(*packed, scal, shape)
        *plain, raw_p = bank._rir_bank_plain(*packed, scal, shape)
        torch.cuda.synchronize()
        check(bank.injected_launch_count == before + 1,
              "injected bank call was not counted once")
        flags_k = raw_k.nonzero().flatten().tolist()
        check(flags_k == raw_p.nonzero().flatten().tolist() == list(degenerate),
              f"{label}: raw-noise fallback entries {flags_k}, expected {list(degenerate)}")
        errs = [(k - q).abs().max().item() for k, q in zip(kern, plain)]
        check(all(np.isfinite(errs)) and max(errs) <= BANK_TOL,
              f"{label} injected kernel vs plain {errs} > {BANK_TOL}")
        injected_err = max(injected_err, *errs)
        print(f"[3b injected] {label}: B={batch} length={shape.length} split="
              f"{shape.split_point} tiles={bank.n_tiles(shape)} raw-noise entries {flags_k} "
              f"max-abs early {errs[0]:.3e} late {errs[1]:.3e} (tol {BANK_TOL})", flush=True)

    # --- 4. main path through render_batch ---
    clips = bench_clips(BATCH, DURATION_S)
    len_out = bench_setup.spec.len_out
    outputs = {}
    bank.launch_count = 0
    back_half_cuda.launch_count = 0  # from here to phase 13: the back halves of phases 4-12
    for fast in (True, False):
        before = bank.launch_count
        back_before = back_half_cuda.launch_count
        t0 = time.perf_counter()
        out = sharding.render_batch(clips, RATE, p, fast_filters=fast, device="cuda")
        wall = time.perf_counter() - t0
        check(bank.launch_count == before + 1, "render_batch did not launch the bank once")
        check(back_half_cuda.launch_count == back_before + 1,
              "render_batch did not launch the back half's kernels once")
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

    # --- 4b. parity path: render(draws=...) and external IRs vs the CPU path ---
    bank.injected_launch_count = 0
    parity = parity_phase(np, pipeline, bank, clips[0])
    injected_launches = bank.injected_launch_count
    check(injected_launches == parity["internal_renders"],
          f"{injected_launches} injected launches for {parity['internal_renders']} renders")

    # --- 4c. metered padded batch through render_batch ---
    bank.launch_count = 0
    metered = metered_batch_phase(np, torch, sharding, loudness, bank, clips)
    main_launches += bank.launch_count
    print("[4c timing] " + json.dumps({"card": card, "nvidia_smi": smi, **metered}), flush=True)

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
        torch.cuda.reset_peak_memory_stats()
        wall, settle, runs = settled_wall(
            torch,
            lambda: sharding._meter(
                sharding._batched_internal(audio_t, seeds_t, ir_sc, mix, setup.ir_shape,
                                           setup.spec),
                RATE, None,
            ),
        )
        timing[f"rtf_{mode}_metered"] = BATCH * DURATION_S / wall
        timing[f"wall_{mode}_metered_s"] = wall
        timing[f"runs_{mode}_metered_s"] = runs
        timing[f"settle_{mode}_metered_s"] = settle
        timing[f"peak_mem_{mode}_metered_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rendered = sharding._batched_internal(audio_t, seeds_t, ir_sc, mix, setup.ir_shape,
                                          setup.spec)
    timing["meter_ms"] = cuda_ms(torch, lambda: loudness.audio_metrics(rendered, RATE), 5)
    del rendered
    shape = bench_setup.ir_shape
    ir_sc = ir_synth.IRScalars.stack([bench_setup.ir_scalars] * BATCH)  # host (B,) arrays
    scal = ir_sc.table(BATCH, "cuda")
    # *_call_ms: CUDA events around back-to-back wrapper calls (host overhead
    # included when it exceeds the kernels); *_device: the kernels alone
    timing["bank_call_ms"], timing["bank_plain_ms"], timing["bank_runs_ms"] = turns(
        torch, lambda: bank._rir_block_cuda(seeds_t, scal, shape),
        lambda: bank._rir_block_plain(seeds_t, scal, shape))
    timing["bank_device"] = device_ms(torch, lambda: bank._rir_block_cuda(seeds_t, scal, shape))
    timing["bank_fused_ms"], timing["bank_fused_plain_ms"], _ = turns(
        torch, lambda: bank.fused_rir_bank(seeds_t, shape, ir_sc),
        lambda: bank._rir_block_plain(seeds_t, ir_sc.table(BATCH, "cuda"), shape))
    timing["scalar_upload_ms"] = cuda_ms(torch, lambda: ir_sc.table(BATCH, "cuda"), 50)
    packed = injected_draws(bank, shape, BATCH, seed=11)
    timing["injected_call_ms"], timing["injected_plain_ms"], timing["injected_runs_ms"] = turns(
        torch, lambda: bank._rir_bank_cuda(*packed, scal, shape),
        lambda: bank._rir_bank_plain(*packed, scal, shape))
    timing["injected_device"] = device_ms(
        torch, lambda: bank._rir_bank_cuda(*packed, scal, shape))
    timing["injected_fused_ms"] = cuda_ms(
        torch, lambda: bank.fused_rir_bank(seeds_t, shape, ir_sc, injected_draws=packed), 50)
    # B=1, the parity path's batch: 18 blocks, far under one wave
    one = injected_draws(bank, shape, 1, seed=12)
    scal1 = bench_setup.ir_scalars.table(1, "cuda")
    timing["b1_bank_call_ms"], timing["b1_bank_plain_ms"], _ = turns(
        torch, lambda: bank._rir_block_cuda(seeds_t[:1], scal1, shape),
        lambda: bank._rir_block_plain(seeds_t[:1], scal1, shape))
    timing["b1_bank_device"] = device_ms(
        torch, lambda: bank._rir_block_cuda(seeds_t[:1], scal1, shape))
    timing["b1_injected_call_ms"], timing["b1_injected_plain_ms"], _ = turns(
        torch, lambda: bank._rir_bank_cuda(*one, scal1, shape),
        lambda: bank._rir_bank_plain(*one, scal1, shape))
    timing["b1_injected_device"] = device_ms(
        torch, lambda: bank._rir_bank_cuda(*one, scal1, shape))
    # the Cathedral shape at B=48: 66 MB of injected noise, more than the L2
    cat_shape = cathedral.ir_shape
    cat_scal = cathedral.ir_scalars.table(BATCH, "cuda")
    cat_packed = injected_draws(bank, cat_shape, BATCH, seed=13)
    timing["cathedral_bank_device"] = device_ms(
        torch, lambda: bank._rir_block_cuda(seeds_t, cat_scal, cat_shape))
    timing["cathedral_injected_device"] = device_ms(
        torch, lambda: bank._rir_bank_cuda(*cat_packed, cat_scal, cat_shape))
    del cat_packed
    timing["bounds"] = {
        "bench_hash": bank_bound(shape, BATCH, False),
        "bench_injected": bank_bound(shape, BATCH, True),
        "b1_hash": bank_bound(shape, 1, False),
        "b1_injected": bank_bound(shape, 1, True),
        "cathedral_hash": bank_bound(cat_shape, BATCH, False),
        "cathedral_injected": bank_bound(cat_shape, BATCH, True),
    }
    timing["parity_cpu_path_s"] = parity["cpu_s"]
    print("[5 timing] " + json.dumps(timing), flush=True)

    # --- 6. the CLIs on the card ---
    bank.launch_count = 0
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli = cli_phase(np, torch, bank, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    main_launches += cli["launches"]
    bank_err = max(bank_err, cli["bank_max_abs_err"])
    print("[6 timing] " + json.dumps({"card": card, "nvidia_smi": smi, **cli}), flush=True)

    # --- 7. the serving path: RenderService and its HTTP job API ---
    del audio_t, packed, one, scal, scal1, cat_scal
    torch.cuda.empty_cache()
    bank.launch_count = 0
    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        serving = serving_phase(np, torch, bank, work, clips)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    main_launches += serving["launches"]
    bank_err = max(bank_err, *serving["bank_errs"])
    print("[7 timing] " + json.dumps({"card": card, "nvidia_smi": smi, **serving["timing"]}),
          flush=True)

    # --- 8. the product surfaces: the render API, the studio, the visualizer, compat ---
    torch.cuda.empty_cache()
    result = product()
    main_launches += result["launches"]
    bank_err = max(bank_err, *result["bank_errs"])

    # --- 9. long clips: the streaming renderer, its routes, its memory ---
    torch.cuda.empty_cache()
    stream = long_clips()
    main_launches += stream["launches"]
    bank_err = max(bank_err, *stream["bank_errs"])

    # --- 10. the tools: bench, profile_exact, bench_long bank, bench_serving, fuzz ---
    torch.cuda.empty_cache()
    tooling = tools({"fast": timing["rtf_fast"], "exact": timing["rtf_exact"]})
    main_launches += tooling["launches"]
    injected_launches += tooling["injected_launches"]
    bank_err = max(bank_err, tooling["bank_errs"][0])
    injected_err = max(injected_err, tooling["bank_errs"][1])

    # --- 11. the codecs: FLAC, Ogg, MP3, AAC in and out of the CLIs and the job API ---
    torch.cuda.empty_cache()
    coded = codecs()
    main_launches += coded["launches"]
    bank_err = max(bank_err, coded["bank_errs"][0])

    # --- 12. the device mesh: data-parallel batch, long render, conv, serving, dry runs ---
    torch.cuda.empty_cache()
    meshed = meshes()
    main_launches += meshed["launches"]
    bank_err = max(bank_err, meshed["bank_errs"][0])

    # --- 13. the back half's kernels at the cells' shapes ---
    back_launches = back_half_cuda.launch_count  # phases 4-12; phase 13's direct calls left out
    check(back_launches > 0, "no render of phases 4-12 launched the back half's kernels")
    torch.cuda.empty_cache()
    back = back_half()

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "audio_raytracing_studio_tpu"))
    check(not foreign, f"JAX or the JAX package was imported: {foreign}")

    source = "audio_raytracing_studio_tpu_torch/csrc/rir_bank.cu"
    print(json.dumps({"kernels": [{
        "name": "rir_bank",
        "route": "cuda",
        "source": source,
        "replaces": "audio_raytracing_studio_tpu/ops/ir_synth_pallas.py:121",
        "launches": main_launches,  # phases 4, 4c, 6, 7, 8, 9, 10, 11 and 12
        "max_abs_err": bank_err,
        "ms": timing["bank_device"]["ms"],
        "plain_ms": timing["bank_plain_ms"],
        "bound_ms": timing["bounds"]["bench_hash"]["bound_ms"],
        "bound_by": timing["bounds"]["bench_hash"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the bank
    }, {
        "name": "rir_bank_injected",
        "route": "cuda",
        "source": source,
        "replaces": "audio_raytracing_studio_tpu/ops/ir_synth_pallas.py:318",
        "launches": injected_launches,  # phases 4b and 10
        "max_abs_err": injected_err,
        "ms": timing["injected_device"]["ms"],
        "plain_ms": timing["injected_plain_ms"],
        "bound_ms": timing["bounds"]["bench_injected"]["bound_ms"],
        "bound_by": timing["bounds"]["bench_injected"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "back_half",
        "route": "cuda",
        "source": "audio_raytracing_studio_tpu_torch/csrc/back_half.cu",
        "replaces": None,  # the JAX package's back half is jnp under XLA's fusion
        "launches": back_launches,  # every render on the card in phases 4 to 12
        "max_abs_err": max(v["max_abs_err"] for v in back.values()),  # phase 13's shapes
        "ms": back["batch48"]["ms"],
        "plain_ms": back["batch48"]["plain_ms"],
        "bound_ms": back["batch48"]["bound_ms"],
        "bound_by": back["batch48"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the back half
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
