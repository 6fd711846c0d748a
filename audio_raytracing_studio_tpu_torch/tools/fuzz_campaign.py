"""Fuzz campaigns for the port — port of ``tools/fuzz_campaign.py``.

    python -m audio_raytracing_studio_tpu_torch.tools.fuzz_campaign MODE [N] \\
        [--start-seed 1000] [--device cuda] [--findings PATH]

Ten modes, each running N seeded cases (case i draws from seed
``start_seed + i``, so a finding replays by its seed), each with the
contract of its JAX counterpart:

- ``parity``: random render configurations over the full UI ranges
  (degenerate corners, every rate the UI can see, mono and stereo, external
  IRs, silent and near-empty clips) through the port's ``render`` with
  injected draws — on a card the injected-draws CUDA bank — and through the
  port's float64 oracle (``oracle.dsp``) with the same draws: max-abs
  ≤ 1e-3, PCM16 within 33 LSB, metered LUFS / RMS within 0.02.
- ``batch``: ``render_batch`` (value parameters sweeping per clip, padded
  clips with ``clip_lengths``, the meter, PCM16 on the device, fast
  filters) against each clip's solo ``render`` with the same hash draws:
  ≤ 2e-4, metrics ≤ 0.03, PCM16 bit-identical to quantizing the floats.
- ``streaming``: ``render_streaming`` at chunk sizes that do not divide the
  clip, against the single-shot ``render``: ≤ 2e-4 (fast air) and ≤ 1e-4
  (exact air), PCM16 on the device bit-identical.
- ``codec``: mutated WAV (PCM16, float), AIFF, FLAC, Ogg/Vorbis and, where
  their libraries load, MP3 and M4A files through ``utils.wavio.read``:
  decode or a clean ``ValueError``.
- ``encode``: ``wavio.write_audio`` of hostile inputs (NaN / Inf, empty,
  one sample, 1-16 channels, extreme rates, int16, strided views) as PCM16
  and float WAV, 16- and 24-bit FLAC, Ogg/Vorbis and, where available, MP3
  and M4A, read back: a clean ``ValueError`` or finite samples, and for
  the lossless formats the right frame count and rate.
- ``http``: hostile bytes against the studio's HTTP server and the job
  API: a parseable status that is never 5xx (the standard library's 501
  aside) or a closed connection, and both servers alive after each case.
- ``soak``: waves of jobs through the job API with small caps: the job
  registry and the upload directory stay bounded, RSS and open files do not
  grow over the steady half.
- ``preset``: ``PresetStore`` operations under hostile names, values and
  file contents: ``ValueError`` / ``FileNotFoundError`` only, nothing
  outside the store touched, saves round-trip.
- ``ui``: type-valid random event sequences through the studio and the
  analyzer UI over HTTP: no 5xx, a parseable ``/state`` at the end.
- ``cli``: hostile argv through ``cli.render``, ``cli.render_dir`` and
  ``cli.analyzer`` in this process: an int exit code or ``SystemExit``,
  never a traceback.

``parity``, ``batch`` and ``streaming`` render on ``--device`` (default
``cuda``); ``http``, ``soak``, ``ui`` and ``cli`` render their few jobs there
too (the studio's process-wide default device is set to it); ``codec``,
``encode`` and ``preset`` are host work.  Each finding prints as one JSON
line to stderr and is appended to ``--findings`` (by default
``fuzz_campaign_torch_findings.jsonl`` in the temporary directory, apart
from the JAX campaign's file), so an interrupted campaign still leaves its
evidence.  The last line is one JSON summary naming the device; the exit
code is 1 when there was any finding.  Without a CUDA device, and without
``--device cpu``, it prints one JSON line with an ``"error"`` and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from ..models import pipeline
from ..oracle import dsp
from ..parallel import sharding, streaming

DEFAULT_FINDINGS = os.path.join(tempfile.gettempdir(), "fuzz_campaign_torch_findings.jsonl")
RATES = [8000, 16000, 22050, 24000, 32000, 44100, 48000]
PARITY_TOL = 1e-3  # the reference contract (BASELINE.json)
PARITY_LSB = 33  # ceil(1e-3 · 32768) + 1
BATCH_TOL = 2e-4
STREAM_TOL = 2e-4
STREAM_EXACT_TOL = 1e-4


@dataclasses.dataclass
class Campaign:
    """One campaign's settings and what it found."""

    device: str = "cuda"
    findings_path: str = DEFAULT_FINDINGS
    findings: int = 0
    worst: float = 0.0  # the largest max-abs a render mode saw

    def record(self, kind: str, payload: dict) -> None:
        self.findings += 1
        line = json.dumps({"kind": kind, "ts": time.time(), **payload}, default=str)
        print(line, file=sys.stderr)
        with open(self.findings_path, "a") as f:
            f.write(line + "\n")

    def release(self) -> None:
        """Drop the cuFFT plans and cached blocks of random shapes."""
        import torch

        if torch.device(self.device).type == "cuda":
            torch.backends.cuda.cufft_plan_cache.clear()
            torch.cuda.empty_cache()


def _progress(mode: str, i: int, n_cases: int, camp: Campaign, t0: float, every: int) -> None:
    if (i + 1) % every == 0:
        print(f"[{mode}] {i + 1}/{n_cases} cases, {camp.findings} findings, "
              f"worst {camp.worst:.2e}, {(time.time() - t0) / (i + 1):.2f} s/case", flush=True)


# ---------------------------------------------------------------- parity ---


def _random_params(rng: np.random.Generator):
    from .. import config
    from ..params import RenderParams

    # the full UI ranges (the reference's slider bounds), the endpoints hit
    # with elevated probability to probe the clip boundaries
    def u(lo, hi, edge_p=0.15):
        r = rng.uniform()
        if r < edge_p / 2:
            return float(lo)
        if r < edge_p:
            return float(hi)
        return float(rng.uniform(lo, hi))

    return RenderParams(
        hall_type=str(rng.choice(["Plate", "Room", "Cathedral"])),
        material=str(rng.choice(list(config.MATERIAL_ABSORPTION))),
        room_size=u(10.0, 1000.0),
        diffusion=u(0.0, 1.0),
        air_absorption=u(0.0, 1.0),
        early_level=u(0.0, 2.0),
        late_level=u(0.0, 2.0),
        dry_wet=u(0.0, 1.0),
        dry_wet_kill_start=u(0.0, 1.0),
        bass_gain=u(0.1, 5.0),
        treble_gain=u(0.1, 5.0),
        x_pos=u(0.0, 1.0),
        y_pos=u(0.0, 1.0),
        z_pos=u(0.0, 1.0),
        target_layout=str(rng.choice(list(config.CHANNEL_LAYOUTS))),
    )


def _random_clip(rng: np.random.Generator, rate: int) -> np.ndarray:
    kind = rng.choice(["tone", "noise", "silence", "impulse", "loud"])
    n = int(rng.integers(max(64, rate // 16), rate))  # up to 1 s
    t = np.arange(n) / rate
    if kind == "tone":
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(30, rate / 2.5) * t)
    elif kind == "noise":
        x = 0.2 * rng.standard_normal(n)
    elif kind in ("silence", "impulse"):
        x = np.zeros(n)
        if kind == "impulse":
            x[int(rng.integers(0, n))] = rng.choice([-1.0, 1.0])
    else:  # loud — exercises the conditional peak normalizations
        x = 1.4 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * rng.standard_normal(n)
    x = x.astype(np.float32)
    if rng.uniform() < 0.4:  # stereo input path
        x = np.stack([x, np.roll(x, n // 7) * 0.8], axis=0)
    return x


def _geometry(p, rate: int):
    """The IR geometry of ``p`` at ``rate`` (the parity tests' helper)."""
    from ..params import (adjust_parameters_for_3d, compute_final_directionality_3d,
                          derive_ir_geometry)

    dur, refs, max_delay, split = adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    directionality = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet)
    return derive_ir_geometry(rate, dur, refs, max_delay, p.material, directionality, split,
                              p.diffusion)


def run_parity(camp: Campaign, n_cases: int, start_seed: int) -> None:
    from ..oracle import loudness as oracle_loudness
    from ..params import IRDraws

    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice(RATES))
        p = _random_params(rng)
        x = _random_clip(rng, rate)
        external_ir = None
        fast = None
        if rng.uniform() < 0.2:
            p = dataclasses.replace(p, use_external_ir=True)
            ir_n = int(rng.integers(16, rate // 2))
            ir = 0.3 * rng.standard_normal((ir_n, 2)).astype(np.float32)
            ir_rate = int(rng.choice(RATES))
            if ir_rate != rate:
                # resample once on the device and feed the result to both
                # sides (the oracle has no resampler)
                ir = pipeline.prepare_external_ir(ir, ir_rate, rate, camp.device).cpu().numpy()
            external_ir = ir
        try:
            # fast filters share the 1e-3 contract; the device meter must
            # match the float64 oracle meter to 0.02
            fast = bool(rng.uniform() < 0.3)
            with_metrics = bool(rng.uniform() < 0.25)
            metrics = None
            if p.use_external_ir:
                ours = pipeline.render(x, rate, p, external_ir=external_ir, fast_filters=fast,
                                       return_metrics=with_metrics, device=camp.device)
                ref = dsp.render(x, rate, p, external_ir=external_ir)
            else:
                d = IRDraws.sample(np.random.default_rng(seed), _geometry(p, rate))
                ours = pipeline.render(x, rate, p, draws=d, fast_filters=fast,
                                       return_metrics=with_metrics, device=camp.device)
                ref = dsp.render(x, rate, p, draws=d)
            if with_metrics:
                ours, metrics = ours
            if ours.shape != ref.shape:
                raise AssertionError(f"shape {ours.shape} vs {ref.shape}")
            err = float(np.max(np.abs(ours - ref)))
            camp.worst = max(camp.worst, err)
            if metrics is not None:
                ref_m = oracle_loudness.calculate_audio_metrics(ref, rate)
                for key in ("lufs", "rms_dbfs"):
                    a, b = float(metrics[key]), float(ref_m[key])
                    finite = np.isfinite(a) and np.isfinite(b)
                    if (finite and abs(a - b) > 0.02) or (np.isfinite(a) != np.isfinite(b)):
                        raise AssertionError(f"metrics {key}: device {a} vs oracle {b}")
            q_ours = dsp.quantize_pcm16(ours)
            q_ref = dsp.quantize_pcm16(ref)
            lsb = int(np.max(np.abs(q_ours.astype(np.int32) - q_ref.astype(np.int32))))
            if err > PARITY_TOL or lsb > PARITY_LSB:
                camp.record("parity_violation", {
                    "seed": seed, "err": err, "lsb": lsb, "rate": rate,
                    "params": p.to_preset_dict(), "clip_shape": list(np.shape(x)),
                    "external": bool(p.use_external_ir), "fast_filters": fast,
                    "with_metrics": with_metrics,
                })
        except Exception as e:  # noqa: BLE001 — the campaign keeps going
            camp.record("parity_crash", {
                "seed": seed, "rate": rate, "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:], "params": p.to_preset_dict(),
                "external": bool(p.use_external_ir), "fast_filters": fast,
            })
        _progress("parity", i, n_cases, camp, t0, 25)
        if (i + 1) % 40 == 0:
            camp.release()


# ----------------------------------------------------------------- codec ---


def _aiff_bytes(samples: np.ndarray, rate: int) -> bytes:
    """A 16-bit AIFF file of (n, channels) float samples."""
    import struct

    pcm = np.clip(np.rint(samples * 32767.0), -32768, 32767).astype(">i2")
    frames, channels = pcm.shape
    exponent = 16383 + int(np.floor(np.log2(rate)))  # 80-bit extended sample rate
    mantissa = int(rate * 2 ** (63 - (exponent - 16383)))
    comm = struct.pack(">hIh", channels, frames, 16) + struct.pack(">HQ", exponent, mantissa)
    ssnd = struct.pack(">II", 0, 0) + pcm.tobytes()
    body = b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


def _encode_corpus(tmpdir: str) -> list:
    """One real file per container and sample format the port reads (MP3 and
    M4A where their libraries load)."""
    from ..utils import lavcio, mp3io, wavio

    rate = 8000
    t = np.arange(rate // 2, dtype=np.float32) / rate
    sig = 0.4 * np.sin(2 * np.pi * 220.0 * t)
    tone = np.stack([sig, 0.8 * sig], axis=1).astype(np.float32)
    out = []
    for name, subtype in (("seed16.wav", "PCM_16"), ("seedf.wav", "FLOAT")):
        path = os.path.join(tmpdir, name)
        wavio.write_audio(path, tone, rate, subtype=subtype)
        out.append(path)
    path = os.path.join(tmpdir, "seed.aiff")
    with open(path, "wb") as f:
        f.write(_aiff_bytes(tone, rate))
    out.append(path)
    exts = ["flac", "ogg"]
    if mp3io.encode_available() and mp3io.decode_available():
        exts.append("mp3")
    if lavcio.encode_available() and lavcio.decode_available():
        exts.append("m4a")
    for ext in exts:
        path = os.path.join(tmpdir, f"seed.{ext}")
        wavio.write_audio(path, tone, rate)
        out.append(path)
    return out


def _mutate(rng: np.random.Generator, blob: bytes) -> bytes:
    buf = bytearray(blob)
    op = rng.choice(["truncate", "bitflip", "byteset", "splice", "extend"])
    if op == "truncate" and len(buf) > 4:
        return bytes(buf[: int(rng.integers(1, len(buf)))])
    if op == "bitflip":
        for _ in range(int(rng.integers(1, 32))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= 1 << int(rng.integers(0, 8))
        return bytes(buf)
    if op == "byteset":
        i = int(rng.integers(0, len(buf)))
        j = min(len(buf), i + int(rng.integers(1, 64)))
        buf[i:j] = bytes([int(rng.integers(0, 256))]) * (j - i)
        return bytes(buf)
    if op == "splice" and len(buf) > 16:
        i = int(rng.integers(0, len(buf) - 8))
        j = int(rng.integers(0, len(buf) - 8))
        n = int(rng.integers(4, min(512, len(buf) - max(i, j))))
        buf[i: i + n] = buf[j: j + n]
        return bytes(buf)
    return bytes(buf) + rng.bytes(int(rng.integers(1, 4096)))  # extend: append garbage


def run_codec(camp: Campaign, n_cases: int, start_seed: int) -> None:
    from ..utils import wavio

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpdir:
        corpus = []
        for path in _encode_corpus(tmpdir):
            with open(path, "rb") as f:
                corpus.append((path, f.read()))
        print(f"[codec] corpus: {[os.path.basename(p) for p, _ in corpus]}")
        work = os.path.join(tmpdir, "mut.bin")
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            src_path, blob = corpus[int(rng.integers(0, len(corpus)))]
            mutated = _mutate(rng, blob)
            # the original extension about half the time: dispatch by sniff
            # and by extension are different code paths
            ext = os.path.splitext(src_path)[1] if rng.uniform() < 0.5 else ".bin"
            path = work + ext
            with open(path, "wb") as f:
                f.write(mutated)
            try:
                data, rate = wavio.read(path)
                if not np.all(np.isfinite(data)):
                    raise AssertionError("non-finite samples returned")
                if not 0 < rate < 10_000_000:
                    raise AssertionError(f"absurd rate {rate}")
            except ValueError:
                pass  # clean rejection — the contract
            except AssertionError as e:
                camp.record("codec_bad_output", {
                    "seed": seed, "src": os.path.basename(src_path), "error": str(e)})
            except Exception as e:  # noqa: BLE001
                camp.record("codec_bad_exception", {
                    "seed": seed, "src": os.path.basename(src_path), "ext": ext,
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                })
            finally:
                if os.path.exists(path):
                    os.unlink(path)
            _progress("codec", i, n_cases, camp, t0, 200)


# ---------------------------------------------------------------- encode ---


def run_encode(camp: Campaign, n_cases: int, start_seed: int) -> None:
    from ..utils import lavcio, mp3io, wavio

    targets = [("wav", "PCM_16"), ("wav", "FLOAT"), ("flac", "PCM_16"), ("flac", "PCM_24"),
               ("ogg", "PCM_16")]
    if mp3io.encode_available() and mp3io.decode_available():
        targets.append(("mp3", "PCM_16"))
    if lavcio.encode_available() and lavcio.decode_available():
        targets.append(("m4a", "PCM_16"))
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpdir:
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            fmt, subtype = targets[int(rng.integers(0, len(targets)))]
            rate = int(rng.choice([1, 7, 8000, 22050, 44100, 48000, 192000, 2_822_400]))
            n = int(rng.choice([0, 1, 2, 63, 1024, int(rng.integers(1, 30000))]))
            ch = int(rng.choice([1, 2, 2, 6, 8, 16]))
            data = (0.5 * rng.standard_normal((n, ch))).astype(np.float32)
            hostile = rng.uniform()
            if hostile < 0.1 and n:
                data[rng.integers(0, n), rng.integers(0, ch)] = np.nan
            elif hostile < 0.2 and n:
                data[rng.integers(0, n), rng.integers(0, ch)] = np.inf
            elif hostile < 0.3:
                data = np.rint(data * 32767).astype(np.int16)
            elif hostile < 0.4:
                data = data[::2]  # a strided view
            path = os.path.join(tmpdir, f"enc_{i}.{fmt}")
            try:
                wavio.write_audio(path, data, rate, subtype=subtype)
                back, back_rate = wavio.read(path)
                finite_in = not (np.issubdtype(data.dtype, np.floating)
                                 and not np.all(np.isfinite(data)))
                if finite_in and not np.all(np.isfinite(back)):
                    raise AssertionError("non-finite decode")
                if data.size and fmt in ("wav", "flac"):  # lossless: exact length
                    if back.shape[0] != data.shape[0]:
                        raise AssertionError(f"frame count {back.shape} vs {data.shape}")
                    if back_rate != rate:
                        raise AssertionError(f"rate {back_rate} vs {rate}")
            except ValueError:
                pass  # clean rejection
            except Exception as e:  # noqa: BLE001
                camp.record("encode_bad_exception", {
                    "seed": seed, "fmt": fmt, "subtype": subtype, "rate": rate,
                    "shape": list(data.shape),
                    "dtype": str(data.dtype), "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                })
            finally:
                if os.path.exists(path):
                    os.unlink(path)
            _progress("encode", i, n_cases, camp, t0, 50)


# ------------------------------------------------------------- streaming ---


def run_streaming(camp: Campaign, n_cases: int, start_seed: int) -> None:
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice([8000, 16000, 22050]))
        p = _random_params(rng)
        x = _random_clip(rng, rate)
        chunk_seconds = float(rng.uniform(0.15, 1.3))
        external_ir = None
        if rng.uniform() < 0.15:
            p = dataclasses.replace(p, use_external_ir=True)
            ir_n = int(rng.integers(16, rate // 2))
            external_ir = 0.3 * rng.standard_normal((ir_n, 2)).astype(np.float32)
        try:
            kw = dict(chunk_seconds=chunk_seconds, device=camp.device)
            if p.use_external_ir:
                kw["external_ir"] = external_ir
            out = streaming.render_streaming(x, rate, p, seed=seed, **kw)
            single = pipeline.render(x, rate, p, seed=seed, external_ir=external_ir,
                                     device=camp.device)
            if out.shape != single.shape:
                raise AssertionError(f"shape {out.shape} vs {single.shape}")
            err = float(np.max(np.abs(out - single)))
            camp.worst = max(camp.worst, err)
            if err > STREAM_TOL:
                raise AssertionError(f"streaming deviation {err:.2e} > {STREAM_TOL}")
            if rng.uniform() < 0.3:  # PCM16 on the device
                q_dev = streaming.render_streaming(x, rate, p, seed=seed, pcm16_output=True,
                                                   **kw)
                q_host = dsp.quantize_pcm16(out)
                if not np.array_equal(q_dev, q_host):
                    raise AssertionError(
                        f"pcm16 mismatch on {int(np.sum(q_dev != q_host))} samples")
            if rng.uniform() < 0.3 and not p.use_external_ir:
                # the exact-air arm matches the exact single-shot render to
                # float32 round-off
                out_x = streaming.render_streaming(x, rate, p, seed=seed, fast_filters=False,
                                                   **kw)
                exact = pipeline.render(x, rate, p, seed=seed, fast_filters=False,
                                        device=camp.device)
                err_x = float(np.max(np.abs(out_x - exact)))
                camp.worst = max(camp.worst, err_x)
                if err_x > STREAM_EXACT_TOL:
                    raise AssertionError(
                        f"exact-air streaming deviation {err_x:.2e} > {STREAM_EXACT_TOL}")
        except AssertionError as e:
            camp.record("streaming_violation", {
                "seed": seed, "rate": rate, "chunk_seconds": chunk_seconds, "error": str(e),
                "params": p.to_preset_dict(), "clip_shape": list(np.shape(x)),
            })
        except Exception as e:  # noqa: BLE001
            camp.record("streaming_crash", {
                "seed": seed, "rate": rate, "chunk_seconds": chunk_seconds,
                "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:],
                "params": p.to_preset_dict(),
            })
        _progress("streaming", i, n_cases, camp, t0, 10)
        if (i + 1) % 20 == 0:
            camp.release()


# ------------------------------------------------------------------ http ---


def _raw_request(port: int, payload: bytes, timeout: float = 20.0) -> bytes:
    """One raw TCP exchange: send ``payload``, read until close or timeout.
    Returns whatever the server sent (b'' if it closed without a byte)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.settimeout(timeout)
        try:
            s.sendall(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the server already rejected — whatever it wrote still counts
        chunks = []
        try:
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
                if len(chunks) > 64:  # don't buffer a result download
                    break
        except (socket.timeout, ConnectionResetError):
            pass
        return b"".join(chunks)


def _status_of(raw: bytes) -> int:
    """HTTP status of the FIRST response in a raw exchange (0: no parseable
    status line — the server just closed)."""
    try:
        parts = raw.split(b"\r\n", 1)[0].decode("latin-1").split()
        if len(parts) >= 2 and parts[0].startswith("HTTP/"):
            return int(parts[1])
    except (ValueError, IndexError):
        pass
    return 0


def _http_alive(port: int, path: str) -> bool:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status == 200
    except Exception:  # noqa: BLE001
        return False


@contextlib.contextmanager
def _workdir(device: str, prefix: str):
    """A temporary working directory, entered for the block and removed after
    it, with the studio's process-wide device set to ``device`` meanwhile."""
    import shutil

    from ..utils.runtime import set_default_device

    cwd = os.getcwd()
    path = tempfile.mkdtemp(prefix=prefix)
    os.chdir(path)
    previous = set_default_device(device)
    try:
        yield path
    finally:
        set_default_device(previous)
        os.chdir(cwd)
        shutil.rmtree(path, ignore_errors=True)


def run_http(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """Hostile HTTP traffic against both of the port's servers.

    The studio server (``app.server`` over the headless runtime) and the job
    API (``serving.service`` over a small ``RenderService``) on ephemeral
    ports get malformed requests: non-HTTP bytes, hostile Content-Length,
    truncated bodies, traversal filenames and upload paths, deep, huge or
    wrong-typed JSON, random methods and paths, pipelined pairs.  Each case:
    a parseable status that is never 5xx (the standard library's 501 for
    unknown methods aside), or a closed connection; after every case both
    servers answer a liveness GET within 60 s.
    """
    with _workdir(camp.device, "ars_torch_httpfuzz_") as tmpdir:
        from ..app import marker, studio
        from ..app.server import StudioHTTPServer
        from ..serving.batcher import RenderService
        from ..serving.service import RenderHTTPService
        from ..utils import wavio
        from ..utils.presets import PresetStore

        marker.ensure_map_asset()
        studio_srv = StudioHTTPServer(studio.build_demo(PresetStore(tmpdir)),
                                      host="127.0.0.1", port=0).start()
        api_srv = RenderHTTPService(
            RenderService(max_batch=2, max_wait_ms=20.0, device=camp.device),
            host="127.0.0.1", port=0, preset_dir=tmpdir,
        ).start()
        try:
            _http_cases(camp, n_cases, start_seed, tmpdir, studio_srv, api_srv, wavio)
        finally:
            studio_srv.stop()
            api_srv.stop()


def _http_cases(camp, n_cases, start_seed, tmpdir, studio_srv, api_srv, wavio) -> None:
    # one real upload, so job payloads can name a valid path
    clip = (0.2 * np.random.default_rng(0).standard_normal(1600)).astype(np.float32)
    wav_path = os.path.join(tmpdir, "seed.wav")
    wavio.write(wav_path, clip, 8000)
    with open(wav_path, "rb") as f:
        uploaded = api_srv.save_upload("seed.wav", f.read())

    def body_json(rng) -> bytes:
        kind = rng.integers(0, 8)
        if kind == 0:
            return b"{"  # truncated JSON
        if kind == 1:
            return b"[" * 2000 + b"]" * 2000  # deep nesting
        if kind == 2:
            return json.dumps({"input": uploaded, "seed": "NaN"}).encode()
        if kind == 3:
            return json.dumps({"input": uploaded, "params": "not-a-dict",
                               "seed": [1, 2]}).encode()
        if kind == 4:
            return json.dumps({"input": "/etc/passwd",
                               "preset": "../../escape_v4.json"}).encode()
        if kind == 5:
            return json.dumps({"id": int(rng.integers(-5, 200)), "value": ["x"] * 5,
                               "event": "click",
                               "set": {str(rng.integers(0, 99)): None}}).encode()
        if kind == 6:
            return os.urandom(int(rng.integers(1, 4096)))
        return json.dumps({"input": uploaded, "format": "exe"}).encode()

    def attack(rng):
        target_api = bool(rng.integers(0, 2))
        port = api_srv.port if target_api else studio_srv.port
        method = str(rng.choice(["GET", "POST", "PUT", "DELETE", "BREW", "P" * 40]))
        paths_api = ["/v1/upload", "/v1/jobs", "/v1/jobs/" + "0" * 32, "/v1/jobs/../../x",
                     "/v1/stats", "/v1/presets", "/" + "a" * 3000]
        paths_studio = ["/", "/state", "/set", "/event", "/upload", "/file?path=/etc/passwd",
                        "/file?path=..%2F..%2Fetc%2Fpasswd", "/%00", "/" + "b" * 3000]
        path = str(rng.choice(paths_api if target_api else paths_studio))
        body = body_json(rng)
        mode = rng.integers(0, 7)
        if mode == 0:  # not HTTP at all
            return port, os.urandom(int(rng.integers(1, 512)))
        if mode == 1:  # hostile Content-Length
            cl = str(rng.choice(["-5", "99999999999999999999", "abc",
                                 str(513 * 1024 * 1024)]))  # just past the upload cap
            return port, (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                          f"Content-Length: {cl}\r\nConnection: close\r\n\r\n"
                          ).encode() + body[:64]
        if mode == 2:  # truncated body (claims more than it sends), close
            claimed = len(body) + int(rng.integers(1, 100000))
            return port, (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                          f"Content-Length: {claimed}\r\nConnection: close\r\n\r\n"
                          ).encode() + body
        if mode == 3:  # header flood, one huge header line
            hdrs = "".join(f"X-H{i}: v\r\n" for i in range(int(rng.integers(1, 150))))
            hdrs += "X-Filename: " + "%2e%2e%2f" * 200 + "\r\n"
            return port, (f"{method} {path} HTTP/1.1\r\nHost: x\r\n{hdrs}"
                          f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                          ).encode() + body
        if mode == 4:  # a pipelined pair on one connection
            one = (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body
            return port, one + b"GET /v1/stats HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        if mode == 5:  # a well-formed hostile request
            name = str(rng.choice(["../../evil.wav", "a" * 500, "%00x", "ok.wav"]))
            return port, (f"{method} {path} HTTP/1.1\r\nHost: x\r\nX-Filename: {name}\r\n"
                          f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                          ).encode() + body
        # no Content-Length at all, but a body
        return port, (f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
                      ).encode() + body

    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        port, payload = attack(rng)
        try:
            raw = _raw_request(port, payload)
            status = _status_of(raw)
        except Exception as e:  # noqa: BLE001
            camp.record("http_client_error", {
                "seed": seed, "error": f"{type(e).__name__}: {e}",
                "payload_head": payload[:200].decode("latin-1", "replace"),
            })
            continue
        if status >= 500 and status != 501:
            camp.record("http_5xx", {
                "seed": seed, "status": status, "port": port, "api": port == api_srv.port,
                "payload_head": payload[:300].decode("latin-1", "replace"),
                "response_head": raw[:300].decode("latin-1", "replace"),
            })
        if not (_http_alive(api_srv.port, "/v1/stats")
                and _http_alive(studio_srv.port, "/state")):
            camp.record("http_server_dead", {
                "seed": seed, "payload_head": payload[:300].decode("latin-1", "replace")})
            break
        _progress("http", i, n_cases, camp, t0, 25)


# ------------------------------------------------------------------ soak ---


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def _open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def run_soak(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """Sustained job load against the job API: boundedness, not speed.

    ``n_cases`` waves of concurrent jobs (result downloads for half,
    abandonment for the rest — the eviction paths) through an in-process
    ``RenderHTTPService`` with small caps (max_jobs=24, max_uploads=8).
    After every wave: the job registry ≤ cap + in-flight, the upload
    directory ≤ cap; at the end RSS and open-file growth over the steady
    part (from the first quarter on) stay under loose ceilings.  Results are
    WAV or FLAC, as in the JAX campaign.
    """
    import urllib.request

    with _workdir(camp.device, "ars_torch_soak_") as tmpdir:
        from ..serving.batcher import RenderService
        from ..serving.service import RenderHTTPService
        from ..utils import wavio

        max_jobs, max_uploads = 24, 8
        srv = RenderHTTPService(
            RenderService(max_batch=4, max_wait_ms=10.0, device=camp.device),
            host="127.0.0.1", port=0, max_jobs=max_jobs, max_uploads=max_uploads,
            preset_dir=tmpdir,
        ).start()
        base = f"http://127.0.0.1:{srv.port}"

        def post(path, body, headers=None):
            req = urllib.request.Request(base + path, data=body, method="POST",
                                         headers=headers or {})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        def get(path, raw=False):
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.read() if raw else json.loads(r.read())

        rss_samples, fd_samples = [], []
        t0 = time.time()
        try:
            for i in range(n_cases):
                seed = start_seed + i
                rng = np.random.default_rng(seed)
                # a fresh upload most waves (upload eviction), a few lengths
                n = int(rng.choice([800, 800, 1600, 3200]))
                clip = (0.2 * rng.standard_normal(n)).astype(np.float32)
                path = os.path.join(tmpdir, "u.wav")
                wavio.write(path, clip, 8000)
                with open(path, "rb") as f:
                    up = post("/v1/upload", f.read(), {"X-Filename": f"u{seed}.wav"})["path"]
                jobs = [post("/v1/jobs", json.dumps({
                    "input": up, "seed": int(rng.integers(0, 99)),
                    "metrics": bool(rng.uniform() < 0.5),
                    "format": str(rng.choice(["wav", "flac"])),
                }).encode())["job_id"] for _ in range(int(rng.integers(2, 6)))]
                # poll to done; download the results of half, abandon the rest
                deadline = time.time() + 300
                for j, jid in enumerate(jobs):
                    while time.time() < deadline:
                        st = get(f"/v1/jobs/{jid}")
                        if st["status"] != "queued":
                            break
                        time.sleep(0.2)
                    if st["status"] != "done":
                        camp.record("soak_job_failed", {"seed": seed, "status": st})
                        continue
                    if j % 2 == 0:
                        get(f"/v1/jobs/{jid}/result", raw=True)
                known = get("/v1/stats").get("jobs_known", 0)
                if known > max_jobs + 8:  # + generous in-flight slack
                    camp.record("soak_unbounded_jobs", {"seed": seed, "jobs_known": known})
                n_uploads = len(os.listdir(srv._uploads.dir))
                if n_uploads > max_uploads:
                    camp.record("soak_unbounded_uploads", {"seed": seed, "files": n_uploads})
                rss_samples.append(_rss_kb())
                fd_samples.append(_open_fds())
                if (i + 1) % 10 == 0:
                    print(f"[soak] {i + 1}/{n_cases} waves, {camp.findings} findings, "
                          f"RSS {rss_samples[-1] // 1024} MB, fds {fd_samples[-1]}, "
                          f"{(time.time() - t0) / (i + 1):.1f} s/wave", flush=True)
        except Exception as e:  # noqa: BLE001 — a refused request is a finding
            camp.record("soak_crash", {"error": f"{type(e).__name__}: {e}",
                                       "trace": traceback.format_exc()[-2000:]})
        finally:
            srv.stop()
    # leak check over the steady part (the first quarter is warm-up)
    q = max(1, len(rss_samples) // 4)
    if len(rss_samples) >= 8:
        rss_growth = rss_samples[-1] - rss_samples[q]
        fd_growth = fd_samples[-1] - fd_samples[q]
        if rss_growth > 200_000:  # > 200 MB of steady growth
            camp.record("soak_rss_growth", {"kb_growth": rss_growth,
                                            "samples": rss_samples[::q]})
        if fd_growth > 32:
            camp.record("soak_fd_growth", {"fd_growth": fd_growth, "samples": fd_samples[::q]})
    if rss_samples:
        print(f"[soak] RSS {rss_samples[0] // 1024}→{rss_samples[-1] // 1024} MB, "
              f"fds {fd_samples[0]}→{fd_samples[-1]}")


# ----------------------------------------------------------------- batch ---


def run_batch(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """``render_batch`` (value parameters sweeping per clip) against each
    clip's solo ``render``: the widened stage flags (air, EQ, early, late
    may differ per clip in one batch — zero-weight and identity-gain clips
    must keep their solo semantics), the masked meter over true spans
    (``clip_lengths``), PCM16 on the device, fast filters."""
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice([8000, 16000]))
        bsz = int(rng.choice([2, 3, 4]))
        shared = _random_params(rng)  # the shape-determining fields come from this draw
        n = int(rng.integers(rate // 8, rate // 2))
        use_buckets = bool(rng.uniform() < 0.3)
        params = [dataclasses.replace(
            _random_params(rng),  # the value fields come from these draws
            hall_type=shared.hall_type, room_size=shared.room_size,
            # z_pos and diffusion set the IR geometry (duration, smoothing
            # width): shape-determining, like hall, room and layout
            z_pos=shared.z_pos, diffusion=shared.diffusion,
            target_layout=shared.target_layout, use_external_ir=False,
        ) for _ in range(bsz)]
        true_lens = ([int(rng.integers(max(64, n // 3), n + 1)) for _ in range(bsz)]
                     if use_buckets else [n] * bsz)
        clips = np.zeros((bsz, n), dtype=np.float32)
        for b in range(bsz):
            clips[b, : true_lens[b]] = (0.3 * rng.standard_normal(true_lens[b])).astype(np.float32)
        seeds = [int(rng.integers(0, 1000)) for _ in range(bsz)]
        fast = bool(rng.uniform() < 0.3)
        with_metrics = bool(rng.uniform() < 0.4)
        pcm16 = bool(rng.uniform() < 0.3)
        try:
            kw = dict(seeds=seeds, fast_filters=fast, device=camp.device)
            if use_buckets:
                kw["clip_lengths"] = true_lens
            out = sharding.render_batch(clips, rate, params, with_metrics=with_metrics, **kw)
            metrics = None
            if with_metrics:
                out, metrics = out
            if pcm16:
                q = sharding.render_batch(clips, rate, params, pcm16_output=True, **kw)
                q_host = dsp.quantize_pcm16(out)
                if not np.array_equal(q, q_host):
                    raise AssertionError(
                        f"pcm16 mismatch on {int(np.sum(q != q_host))} samples")
            for b in range(bsz):
                solo = pipeline.render(clips[b, : true_lens[b]], rate, params[b],
                                       seed=seeds[b], fast_filters=fast,
                                       return_metrics=with_metrics, device=camp.device)
                solo_m = None
                if with_metrics:
                    solo, solo_m = solo
                err = float(np.max(np.abs(out[b, : solo.shape[0]] - solo)))
                camp.worst = max(camp.worst, err)
                if err > BATCH_TOL:
                    raise AssertionError(f"clip {b}: batch vs solo {err:.2e}")
                if metrics is not None:
                    for key in ("lufs", "rms_dbfs"):
                        a, c = float(metrics[b][key]), float(solo_m[key])
                        if (np.isfinite(a) != np.isfinite(c)) or (
                                np.isfinite(a) and abs(a - c) > 0.03):
                            raise AssertionError(f"clip {b} metrics {key}: batch {a} vs solo {c}")
        except AssertionError as e:
            camp.record("batch_violation", {
                "seed": seed, "rate": rate, "batch": bsz, "error": str(e),
                "fast_filters": fast, "buckets": use_buckets, "shared": shared.to_preset_dict(),
            })
        except Exception as e:  # noqa: BLE001
            camp.record("batch_crash", {
                "seed": seed, "rate": rate, "batch": bsz, "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            })
        _progress("batch", i, n_cases, camp, t0, 5)
        if (i + 1) % 40 == 0:
            camp.release()


# ---------------------------------------------------------------- preset ---


def _hostile_name(rng: np.random.Generator) -> str:
    """Preset names a hostile or confused client might send."""
    pools = [
        lambda: "Mein Preset " + str(rng.integers(100)),
        lambda: rng.choice(["", " ", ".", "..", "...", "_", "-", "_v4.json"]),
        lambda: "../" * int(rng.integers(1, 4)) + "etc/passwd",
        lambda: "..\\" * int(rng.integers(1, 4)) + "windows",
        lambda: "a/b/" + str(rng.integers(10)),
        lambda: "x\x00y" + str(rng.integers(10)),
        lambda: "".join(chr(int(c)) for c in rng.integers(1, 32, size=6)),
        lambda: "名前🎵" + str(rng.integers(10)),
        lambda: "A" * int(rng.integers(200, 500)),
        lambda: str(rng.choice(["CON", "NUL", "aux", "last_preset_v4"])),
        lambda: "".join(chr(int(c))
                        for c in rng.integers(32, 0x2FF, size=int(rng.integers(1, 20)))),
    ]
    return str(pools[int(rng.integers(len(pools)))]())


def _hostile_preset_value(rng: np.random.Generator):
    """A random JSON value for one preset key."""
    r = rng.uniform()
    if r < 0.25:
        return float(rng.uniform(-1e3, 1e3))
    if r < 0.35:
        return float(rng.choice([np.inf, -np.inf, np.nan, 1e308, -0.0, 5e-324]))
    if r < 0.5:
        return str(rng.choice(["Plate", "xxx", "1.5", "inf", "nan", "", "1e999"]))
    if r < 0.6:
        return bool(rng.integers(2))
    if r < 0.7:
        return None
    if r < 0.8:
        return [1, 2, 3]
    if r < 0.9:
        return {"a": 1}
    return int(rng.integers(-(2**40), 2**40))


def run_preset(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """``PresetStore`` operations and ``RenderParams`` coercion under hostile
    names, values and file contents.  Each case: every store operation
    returns or raises ``ValueError`` (``JSONDecodeError`` included) /
    ``FileNotFoundError``; nothing outside ``<base>/presets_v4`` (and the
    named zip) is created, changed or deleted; a successful save round-trips
    and moves the last-used pointer; ``from_preset_dict`` is total over any
    JSON value per key and raises ``ValueError`` for a non-object."""
    import shutil

    from .. import config
    from ..params import RenderParams
    from ..utils.presets import PresetStore

    clean = (ValueError, FileNotFoundError)

    def snapshot(root: str) -> dict:
        out = {}
        for dp, _, fns in os.walk(root):
            for fn in fns:
                p = os.path.join(dp, fn)
                try:
                    out[p] = os.path.getsize(p)
                except OSError:
                    out[p] = -1
        return out

    def fields_equal(a, b) -> bool:
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, float) and isinstance(vb, float):
                if not (va == vb or (np.isnan(va) and np.isnan(vb))):
                    return False
            elif va != vb:
                return False
        return True

    def one_op(store, preset_dir, zip_target, rng, op, name):
        if op == "save":
            p = _random_params(rng)
            if rng.uniform() < 0.3:
                p = dataclasses.replace(
                    p, room_size=float(rng.choice([np.nan, np.inf, -np.inf, 1e308])))
            _, filename = store.save(name, p)
            loaded = store.load(filename)
            again = RenderParams.from_preset_dict(p.to_preset_dict())
            if not fields_equal(p, again) or not fields_equal(again, loaded):
                raise AssertionError(f"save/load round-trip mismatch for {name!r}")
            if store.load_last() != filename:
                raise AssertionError("last-used pointer not updated")
        elif op == "load":
            existing = store.list_presets()
            target = str(rng.choice(existing)) if existing and rng.uniform() < 0.5 else name
            if not isinstance(store.load(target), RenderParams):
                raise AssertionError("load returned non-params")
        elif op == "delete":
            if not isinstance(store.delete(name), bool):
                raise AssertionError("delete returned non-bool")
        elif op == "list":
            store.list_presets()
        elif op == "zip":
            store.export_zip(zip_target)
        elif op == "corrupt":
            store.ensure_dir()
            fn = os.path.join(preset_dir, f"c{int(rng.integers(5))}_v4.json")
            kind = rng.uniform()
            if kind < 0.3:
                body = rng.bytes(int(rng.integers(0, 200)))
            elif kind < 0.6:
                body = json.dumps([_hostile_preset_value(rng) for _ in range(3)]).encode()
            else:
                body = json.dumps({k: _hostile_preset_value(rng)
                                   for k in list(config.PRESET_KEYS)[: int(rng.integers(0, 17))]
                                   }).encode()
            with open(fn, "wb") as f:
                f.write(body)
            if not isinstance(store.load(os.path.basename(fn)), RenderParams):
                raise AssertionError("load returned non-params")
        elif op == "last":
            store.ensure_dir()
            with open(store.last_preset_file, "wb") as f:
                f.write(rng.bytes(int(rng.integers(0, 40))))
            last = store.load_last()
            if last is not None and not isinstance(last, str):
                raise AssertionError("load_last returned non-str")
        else:  # raw_dict — from_preset_dict is total
            val = _hostile_preset_value(rng)
            if isinstance(val, dict) or rng.uniform() < 0.5:
                RenderParams.from_preset_dict({k: _hostile_preset_value(rng)
                                               for k in list(config.PRESET_KEYS)})
            else:
                try:
                    RenderParams.from_preset_dict(val)
                except ValueError:
                    return
                raise AssertionError(f"from_preset_dict accepted {type(val)}")

    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        case_dir = tempfile.mkdtemp(prefix="ars_torch_presetfuzz_")
        decoy = os.path.join(case_dir, "decoy", "secret.txt")
        os.makedirs(os.path.dirname(decoy))
        with open(decoy, "w") as f:
            f.write("canary")
        base = os.path.join(case_dir, "store")
        os.makedirs(base)
        store = PresetStore(base)
        preset_dir = os.path.realpath(store.preset_dir)
        zip_target = os.path.join(case_dir, "export.zip")
        op_log = []
        try:
            for _ in range(int(rng.integers(8, 25))):
                before = snapshot(case_dir)
                op = str(rng.choice(["save", "load", "delete", "list", "zip", "corrupt",
                                     "last", "raw_dict"]))
                name = _hostile_name(rng)
                op_log.append((op, name[:40]))
                try:
                    one_op(store, preset_dir, zip_target, rng, op, name)
                except clean:
                    pass
                after = snapshot(case_dir)
                for path in set(before) | set(after):
                    real = os.path.realpath(path)
                    inside = (real.startswith(preset_dir + os.sep)
                              or real == os.path.realpath(zip_target))
                    if not inside and before.get(path) != after.get(path):
                        raise AssertionError(f"op {op}({name!r}) touched {path} outside the store")
                with open(decoy) as f:
                    if f.read() != "canary":
                        raise AssertionError("decoy file modified")
        except AssertionError as e:
            camp.record("preset_violation", {"seed": seed, "error": str(e), "ops": op_log[-5:]})
        except Exception as e:  # noqa: BLE001
            camp.record("preset_bad_exception", {
                "seed": seed, "error": f"{type(e).__name__}: {e}", "ops": op_log[-5:],
                "trace": traceback.format_exc()[-2000:],
            })
        finally:
            shutil.rmtree(case_dir, ignore_errors=True)
        _progress("preset", i, n_cases, camp, t0, 25)


# -------------------------------------------------------------------- ui ---


def run_ui(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """Type-valid adversarial traffic through the studio's event graph.

    Every value sent is one the browser front end could produce — member
    dropdown choices, finite in-range sliders, booleans, arbitrary unicode
    text, real uploads, map clicks at arbitrary pixels — in random event
    sequences, so any 5xx is a handler fault and a dead server or an
    unparseable ``/state`` a runtime fault.  One case: a fresh studio (or,
    30% of the time, the analyzer UI) server and 10-30 seeded operations,
    at most two of them renders.
    """
    import io
    import urllib.error
    import urllib.request

    from ..utils import wavio

    def post(port, path, payload: dict):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(payload).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=180) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    def upload(port, name, body: bytes):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upload", data=body,
                                     headers={"X-Filename": name}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())["path"]

    def state(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=60) as r:
            return json.loads(r.read())["components"]

    def valid_value(rng, comp):
        t = comp["type"]
        if t == "Slider":
            lo = float(comp.get("minimum", 0.0))
            hi = float(comp.get("maximum", 1.0))
            r = rng.uniform()
            return lo if r < 0.15 else hi if r < 0.3 else float(rng.uniform(lo, hi))
        if t == "Checkbox":
            return bool(rng.integers(2))
        if t == "Dropdown":
            choices = comp.get("choices") or []
            if not choices or rng.uniform() < 0.1:
                return None
            return str(rng.choice(choices))
        if t == "Number":
            return float(rng.uniform(-1e6, 1e6))
        return _hostile_name(rng).replace("\x00", "")[:250]  # text of any kind

    def one_case(rng, case_dir, op_log):
        from ..app import analyzer_ui, marker, studio
        from ..app.server import StudioHTTPServer
        from ..utils.presets import PresetStore

        marker.ensure_map_asset()
        demo = (analyzer_ui.build_demo() if rng.uniform() < 0.3
                else studio.build_demo(PresetStore(case_dir)))
        srv = StudioHTTPServer(demo, host="127.0.0.1", port=0).start()
        try:
            paths = []
            for u in range(2):
                rate = int(rng.choice([8000, 16000, 44100]))
                x = (0.4 * rng.standard_normal(int(rng.integers(200, rate // 2)))
                     ).astype(np.float32)
                if rng.uniform() < 0.4:
                    x = np.stack([x, x * 0.5], axis=1)
                buf = io.BytesIO()
                wavio.write(buf, x, rate)
                paths.append(upload(srv.port, f"clip{u}.wav", buf.getvalue()))
            renders_left = 2
            for _ in range(int(rng.integers(10, 30))):
                comps = state(srv.port)
                op = rng.choice(["set", "set", "event", "upload_set", "select"])
                if op == "set":
                    comp = comps[int(rng.integers(len(comps)))]
                    value = valid_value(rng, comp)
                    op_log.append(("set", comp["type"], str(value)[:30]))
                    code, _ = post(srv.port, "/set", {"id": comp["id"], "value": value,
                                                      "fire_change": bool(rng.integers(2))})
                elif op == "upload_set":
                    targets = [c for c in comps if c["type"] in ("Audio", "File")]
                    if not targets:
                        continue
                    comp = targets[int(rng.integers(len(targets)))]
                    op_log.append(("upload_set", comp.get("label")))
                    code, _ = post(srv.port, "/set", {"id": comp["id"],
                                                      "value": str(rng.choice(paths))})
                elif op == "select":
                    sel = [c for c in comps if "select" in c.get("events", ())]
                    if not sel:
                        continue
                    comp = sel[int(rng.integers(len(sel)))]
                    index = [int(rng.integers(-50, 2000)), int(rng.integers(-50, 2000))]
                    op_log.append(("select", comp.get("label"), index))
                    code, _ = post(srv.port, "/event", {"id": comp["id"], "event": "select",
                                                        "index": index})
                else:
                    evented = [(c, e) for c in comps for e in c.get("events", ())]
                    comp, event = evented[int(rng.integers(len(evented)))]
                    label = str(comp.get("label") or comp.get("value"))
                    if "Verarbeiten" in label or "Bearbeiten" in label:
                        if renders_left <= 0:
                            continue
                        renders_left -= 1
                    op_log.append(("event", label[:30], event))
                    payload = {"id": comp["id"], "event": event}
                    if event == "select":
                        payload["index"] = [int(rng.integers(0, 900)),
                                            int(rng.integers(0, 900))]
                    code, _ = post(srv.port, "/event", payload)
                if code >= 500:
                    raise AssertionError(f"5xx ({code}) on {op_log[-1]!r} with UI-shaped input")
            state(srv.port)  # still a parseable state
        finally:
            srv.stop()

    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        op_log = []
        with _workdir(camp.device, "ars_torch_uifuzz_") as case_dir:
            try:
                one_case(rng, case_dir, op_log)
            except AssertionError as e:
                camp.record("ui_violation", {"seed": seed, "error": str(e), "ops": op_log[-6:]})
            except Exception as e:  # noqa: BLE001
                camp.record("ui_crash", {
                    "seed": seed, "error": f"{type(e).__name__}: {e}", "ops": op_log[-6:],
                    "trace": traceback.format_exc()[-2000:],
                })
        _progress("ui", i, n_cases, camp, t0, 5)


# ------------------------------------------------------------------- cli ---


def run_cli(camp: Campaign, n_cases: int, start_seed: int) -> None:
    """Hostile argv through the three CLI entry points, in this process.

    Each case: ``main(argv)`` returns an int exit code or raises
    ``SystemExit`` — never any other exception — and stderr carries
    ``error: ...`` messages, never a traceback.  Inputs may be hostile
    (missing files, directories, bytes behind an audio magic, empty files);
    outputs stay in the case's directory.  A share of the cases use a valid
    tiny clip with sane flags, so the deep paths (render, sweep, stream,
    metrics, binaural, json, convert, normalize) run.  Every argv ends with
    ``--device`` and the campaign's device.
    """
    import contextlib
    import io
    import shutil

    from ..cli import analyzer as cli_analyzer
    from ..cli import render as cli_render
    from ..cli import render_dir as cli_render_dir
    from ..utils import wavio

    halls = ["Plate", "Room", "Cathedral"]
    layouts = ["Stereo", "5.1 (Standard)", "7.1 (Surround)"]
    value_flags = ["--room-size", "--diffusion", "--air-absorption", "--early-level",
                   "--late-level", "--dry-wet", "--kill-start", "--bass-gain",
                   "--treble-gain", "--x", "--y", "--z", "--seed"]

    def num_str(rng) -> str:
        return str(rng.choice(["0.5", "1", "-3", "0", "1e9", "-1e9", "inf", "-inf", "nan",
                               "abc", "", "0.0001", "99999", "--", "0x10", "1_000"]))

    def make_inputs(rng, case_dir: str) -> list:
        ok = os.path.join(case_dir, "ok.wav")
        rate = int(rng.choice([8000, 16000]))
        x = (0.4 * rng.standard_normal(int(rng.integers(400, rate)))).astype(np.float32)
        if rng.uniform() < 0.3:
            x = np.stack([x, 0.5 * x], axis=1)
        wavio.write(ok, x, rate)
        bad = os.path.join(case_dir, "bad.wav")
        with open(bad, "wb") as f:
            f.write(b"RIFF" + rng.bytes(int(rng.integers(0, 64))))
        empty = os.path.join(case_dir, "empty.flac")
        open(empty, "wb").close()
        return [ok, bad, empty, os.path.join(case_dir, "missing.wav"),
                case_dir]  # the last: a directory where a file is expected

    def random_argv(rng, case_dir: str, inputs: list):
        sane = rng.uniform() < 0.35
        out = os.path.join(case_dir, str(rng.choice(
            ["out.wav", "out.flac", "out.ogg", "out.mp3", "o{i}.wav", "out.xyz", "out"])))
        tool = rng.choice(["render", "render_dir", "analyzer"])
        if tool == "analyzer":
            sub = str(rng.choice(["analyze", "normalize", "convert", "bogus"]))
            argv = [sub, inputs[0] if sane else str(rng.choice(inputs))]
            if sub in ("normalize", "convert") or rng.uniform() < 0.3:
                argv.append(out)
            for _ in range(int(rng.integers(0, 3))):
                flag = str(rng.choice(["--target", "--bitrate", "--samplerate"]))
                argv += [flag, "8000" if sane and flag == "--samplerate"
                         else ("-16" if sane else num_str(rng))]
            return cli_analyzer.main, argv
        if tool == "render_dir":
            indir = os.path.join(case_dir, "in")
            os.makedirs(indir, exist_ok=True)
            if rng.uniform() < 0.7:
                shutil.copy(inputs[0], os.path.join(indir, "a.wav"))
            if rng.uniform() < 0.3:
                shutil.copy(inputs[1], os.path.join(indir, "b.wav"))
            argv = [indir if sane else str(rng.choice([indir, inputs[3], inputs[0]])),
                    os.path.join(case_dir, "outdir")]
            fn = cli_render_dir.main
        else:
            argv = [inputs[0] if sane else str(rng.choice(inputs)), out]
            fn = cli_render.main
            if rng.uniform() < 0.2:
                argv += ["--sweep", str(rng.choice([
                    "diffusion=0.2,0.8", "z=0.1,0.9", "bogus=1,2", "diffusion=",
                    "diffusion=a,b", "=1,2"]))]
            if rng.uniform() < 0.15:
                argv += ["--stream", "--chunk-seconds", "1" if sane else num_str(rng)]
            if rng.uniform() < 0.15:
                argv += ["--binaural"]
        for _ in range(int(rng.integers(0, 5))):
            r = rng.uniform()
            if r < 0.3:
                argv += ["--hall", str(rng.choice(halls if sane else halls + ["Dome", ""]))]
            elif r < 0.5:
                argv += ["--layout", str(rng.choice(layouts))]
            elif r < 0.9:
                argv += [str(rng.choice(value_flags)),
                         str(rng.uniform(0, 2))[:6] if sane else num_str(rng)]
            else:
                argv += [str(rng.choice(["--metrics", "--json", "--preset", "--bogus-flag"]))]
        return fn, argv

    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        case_dir = tempfile.mkdtemp(prefix="ars_torch_clifuzz_")
        inputs = make_inputs(rng, case_dir)
        fn, argv = random_argv(rng, case_dir, inputs)
        argv += ["--device", camp.device]
        out_buf, err_buf = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out_buf), contextlib.redirect_stderr(err_buf):
                try:
                    rc = fn(argv)
                except SystemExit:
                    rc = 0  # an argparse exit — clean by contract
            if rc is not None and not isinstance(rc, int):
                raise AssertionError(f"main returned {type(rc).__name__}")
            if "Traceback (most recent call last)" in err_buf.getvalue():
                raise AssertionError("traceback printed to stderr")
        except AssertionError as e:
            camp.record("cli_violation", {"seed": seed, "error": str(e), "argv": argv[:20],
                                          "stderr_tail": err_buf.getvalue()[-500:]})
        except Exception as e:  # noqa: BLE001
            camp.record("cli_bad_exception", {
                "seed": seed, "error": f"{type(e).__name__}: {e}", "argv": argv[:20],
                "trace": traceback.format_exc()[-2000:],
            })
        finally:
            shutil.rmtree(case_dir, ignore_errors=True)
        _progress("cli", i, n_cases, camp, t0, 10)


MODES = {
    "parity": run_parity,
    "batch": run_batch,
    "streaming": run_streaming,
    "codec": run_codec,
    "encode": run_encode,
    "http": run_http,
    "soak": run_soak,
    "preset": run_preset,
    "ui": run_ui,
    "cli": run_cli,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=list(MODES))
    ap.add_argument("cases", nargs="?", type=int, default=100)
    ap.add_argument("--start-seed", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    ap.add_argument("--findings", default=DEFAULT_FINDINGS,
                    help="JSON-lines file the findings are appended to")
    args = ap.parse_args(argv)
    from .bench_long import card, needs_card

    error = needs_card(args.device)
    if error:
        print(json.dumps({"metric": "fuzz_campaign", "mode": args.mode, "error": error}))
        return 1
    camp = Campaign(device=args.device, findings_path=args.findings)
    t0 = time.time()
    MODES[args.mode](camp, args.cases, args.start_seed)
    print(f"[{args.mode}] DONE: {args.cases} cases, {camp.findings} findings, "
          f"worst {camp.worst:.2e}", flush=True)
    print(json.dumps({
        "metric": "fuzz_campaign", "mode": args.mode, "cases": args.cases,
        "start_seed": args.start_seed, "findings": camp.findings, "worst_max_abs": camp.worst,
        "seconds": time.time() - t0, "findings_path": args.findings,
        "device": card(args.device),
    }))
    return 1 if camp.findings else 0


if __name__ == "__main__":
    sys.exit(main())
