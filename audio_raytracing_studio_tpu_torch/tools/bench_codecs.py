"""Host codec throughput — port of ``tools/bench_codecs.py``.

    python -m audio_raytracing_studio_tpu_torch.tools.bench_codecs \\
        [--lengths 60 600] [--codecs wav flac ogg mp3 m4a] [--device cuda]

Uploads decode on the HTTP thread of the job API (``serving.service``) and
the CLIs encode every result they write, so codec speed is part of the
serving story: a slow decoder holds back the dispatch loop.  For each codec
and clip length this writes the ``music_like`` signal (44.1 kHz stereo)
with ``utils.wavio.write_audio``, reads it back with ``wavio.read``, and
prints one JSON line with the wall-clock encode and decode seconds, their
realtime factors (audio seconds per wall second), the file's MB and the
tier that decoded it.  A codec whose library is absent prints
``"available": false`` and no numbers.  A last line per length times the
PCM16 conversion (``wavio.encode_pcm16`` / ``decode_pcm16``) through the
C++ loop of ``_native/pcm_codec.cc`` and through NumPy, and says whether
the two agree bit for bit.

All of it is host work: the lines carry ``"host_only": true`` and name the
machine by its card (``tools.bench_long.card``), because the numbers are
that machine's CPU.  Without a CUDA device, and without ``--device cpu``, it
prints one JSON line with an ``"error"`` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

RATE = 44100
CODEC_EXT = {"wav": ".wav", "flac": ".flac", "ogg": ".ogg", "mp3": ".mp3", "m4a": ".m4a"}
METRIC = "host codec throughput (audio-sec/sec)"


def music_like(seconds: float, rate: int = RATE, channels: int = 2) -> np.ndarray:
    """Deterministic music-like test signal: AM'd harmonic stack + noise.

    Lossy encoders' speed depends on content (residue and psychoacoustic
    work scale with spectral complexity), so a bare sine would flatter them.
    """
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(0xC0DEC)
    sig = np.zeros((n, channels), dtype=np.float64)
    for ch in range(channels):
        for k, f0 in enumerate((110.0, 220.0, 330.0, 554.37, 880.0)):
            am = 0.5 + 0.5 * np.sin(2 * np.pi * (0.3 + 0.13 * k) * t + ch)
            sig[:, ch] += am * np.sin(2 * np.pi * f0 * (1 + 0.001 * ch) * t) / (k + 1)
        sig[:, ch] += 0.05 * rng.standard_normal(n)
    sig *= 0.5 / np.max(np.abs(sig))
    return sig.astype(np.float32)


def available(codec: str) -> bool:
    if codec in ("wav", "flac", "ogg"):
        return True  # in-repo codecs (NumPy where the native loops cannot build)
    if codec == "mp3":
        from ..utils import mp3io

        return mp3io.encode_available() and mp3io.decode_available()
    if codec == "m4a":
        from ..utils import lavcio

        return lavcio.encode_available() and lavcio.decode_available()
    return False


def decode_tier(codec: str) -> str:
    """Which of ``wavio.read``'s tiers decodes this codec here."""
    from ..utils import _native_flac, _native_pcm, _native_vorbis, lavcio

    if codec == "wav":
        return "wavio+native" if _native_pcm.available() else "wavio"
    if codec == "flac":
        return "flacio+native" if _native_flac.available() else "flacio"
    if codec == "ogg":
        if lavcio.decode_available():
            return "lavc"
        return "vorbisio+native" if _native_vorbis.available() else "vorbisio"
    return {"mp3": "mpg123", "m4a": "lavc"}[codec]


def bench_one(codec: str, seconds: float, workdir: str) -> dict:
    from ..utils import wavio

    data = music_like(seconds)
    path = os.path.join(workdir, f"bench_{codec}_{int(seconds)}s{CODEC_EXT[codec]}")

    t0 = time.perf_counter()
    wavio.write_audio(path, data, RATE)
    enc_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out, rate = wavio.read(path)
    dec_s = time.perf_counter() - t0

    if rate != RATE:
        raise AssertionError(f"{codec}: rate {rate} != {RATE}")
    drift = abs(out.shape[0] - data.shape[0])
    if drift > RATE // 10:
        raise AssertionError(f"{codec}: length drift {drift} samples")
    size = os.path.getsize(path)
    os.remove(path)
    return {
        "codec": codec,
        "clip_s": seconds,
        "available": True,
        "tier": decode_tier(codec),
        "encode_s": enc_s,
        "decode_s": dec_s,
        "encode_x_rt": seconds / enc_s,
        "decode_x_rt": seconds / dec_s,
        "mb": size / 1e6,
    }


def bench_pcm16(seconds: float) -> dict:
    """PCM16 encode / decode of the ``music_like`` clip through the native
    loop and through NumPy (best of 3 each)."""
    from ..utils import _native_pcm

    data = music_like(seconds)

    def best(fn, arg):
        times, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(arg)
            times.append(time.perf_counter() - t0)
        return min(times), out

    def numpy_encode(x):
        return np.clip(np.rint(x * np.float32(32768.0)), -32768, 32767).astype(np.int16)

    def numpy_decode(raw):
        return raw.astype(np.float32) / 32768.0

    row = {"codec": "pcm16", "clip_s": seconds, "available": _native_pcm.available()}
    np_enc_s, pcm = best(numpy_encode, data)
    np_dec_s, back = best(numpy_decode, pcm)
    row.update(numpy_encode_s=np_enc_s, numpy_decode_s=np_dec_s)
    if row["available"]:
        nat_enc_s, pcm_native = best(_native_pcm.encode_pcm16, data)
        nat_dec_s, back_native = best(_native_pcm.decode_pcm16, pcm)
        row.update(native_encode_s=nat_enc_s, native_decode_s=nat_dec_s,
                   bit_equal=bool(np.array_equal(pcm, pcm_native)
                                  and np.array_equal(back, back_native)))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", type=float, nargs="+", default=[60.0, 600.0])
    ap.add_argument("--codecs", nargs="+", default=list(CODEC_EXT), choices=list(CODEC_EXT))
    ap.add_argument("--device", default="cuda",
                    help="names the machine the lines were measured on (default cuda; "
                         "the work is host work)")
    args = ap.parse_args(argv)
    from .bench_long import card, needs_card

    error = needs_card(args.device)
    if error:
        print(json.dumps({"metric": METRIC, "error": error}))
        return 1
    common = {"metric": METRIC, "host_only": True, "device": card(args.device)}
    with tempfile.TemporaryDirectory(prefix="ars_torch_codecs_") as workdir:
        for codec in args.codecs:
            for seconds in args.lengths:
                if not available(codec):
                    row = {"codec": codec, "clip_s": seconds, "available": False}
                else:
                    row = bench_one(codec, seconds, workdir)
                print(json.dumps({**common, **row}), flush=True)
    for seconds in args.lengths:
        print(json.dumps({**common, **bench_pcm16(seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
