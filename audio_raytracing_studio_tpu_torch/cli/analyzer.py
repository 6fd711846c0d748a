"""Audio analyzer CLI — port of ``audio_raytracing_studio_tpu/cli/analyzer.py``.

File analysis (rate / channels / duration / LUFS, optionally the 4×
oversampled true peak), normalization to a target LUFS by a static gain,
and format conversion with an optional rate change (``ops.resample.
resample_poly``).  Measurement and resampling run on the CUDA device unless
``--device cpu`` is given; ``--backend oracle`` meters with the float64
NumPy meter (``oracle.loudness``) on the host instead.  WAV, FLAC and
Ogg/Vorbis convert with the in-repo codecs, MP3 through libmp3lame and
AAC / M4A through the FFmpeg libraries (``utils.mp3io``, ``utils.lavcio``);
the ffmpeg binary is only the last tier where a library is absent.

Usage:
  python -m audio_raytracing_studio_tpu_torch.cli.analyzer analyze in.wav --true-peak
  python -m audio_raytracing_studio_tpu_torch.cli.analyzer normalize in.wav out.wav --target -16
  python -m audio_raytracing_studio_tpu_torch.cli.analyzer convert in.wav out.mp3 --bitrate 256
  python -m audio_raytracing_studio_tpu_torch.cli.analyzer convert in.flac out.ogg --samplerate 48000
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..analysis.metrics import calculate_audio_metrics
from ..utils import wavio
from ..utils.runtime import ensure_device


def analyze(path: str, true_peak: bool = False, device="cuda",
            backend: str = "torch") -> dict:
    """Rate / channels / duration / LUFS (the reference's analyser.py:50-70).

    ``true_peak=True`` also reports the 4× oversampled inter-sample true peak
    (BS.1770 Annex 2, ``metering.loudness.oversampled_true_peak_dbfs``); the
    reference's "Peak" is the plain sample peak despite its label
    (raytracer_studio.py:695-697), kept as it is.
    """
    data, rate = wavio.read(path)
    metrics = calculate_audio_metrics(data, rate, device=device, backend=backend)
    lufs = metrics["lufs"]
    peak = metrics["true_peak_dbfs"]
    result = {
        "Pfad": str(path),
        "Abtastrate": rate,
        "Kanäle": data.shape[1],
        "Dauer (Sekunden)": round(data.shape[0] / rate if rate > 0 else 0.0, 2),
        "LUFS": round(lufs, 2) if lufs is not None and np.isfinite(lufs) else "Nicht messbar",
        "Peak (dBFS)": round(peak, 2)
        if peak is not None and np.isfinite(peak) else "-inf",
    }
    if true_peak:
        from ..metering.loudness import oversampled_true_peak_dbfs

        x = torch.from_numpy(np.ascontiguousarray(data.T)).to(ensure_device(device))
        tp = float(oversampled_true_peak_dbfs(x))
        result["True Peak 4x (dBTP)"] = round(tp, 2) if np.isfinite(tp) else "-inf"
    return result


def normalize_to_lufs(
    input_path: str, output_path: str, target_lufs: float = -16.0, device="cuda",
    backend: str = "torch",
) -> dict:
    """Static-gain normalization to the target integrated loudness, written
    as PCM16 by ``wavio.write_audio``.

    For integrated-loudness targeting a constant gain is exact (loudness is
    gain-equivariant) and keeps the dynamics untouched.
    """
    data, rate = wavio.read(input_path)
    lufs = calculate_audio_metrics(data, rate, device=device, backend=backend)["lufs"]
    if lufs is None or not np.isfinite(lufs):
        raise ValueError("LUFS nicht messbar (Stille oder zu kurz)")
    gain_db = target_lufs - lufs
    gain = 10.0 ** (gain_db / 20.0)
    scaled = data * gain
    clipped = bool(np.any(np.abs(scaled) > 1.0))
    out = np.clip(scaled, -1.0, 1.0)
    wavio.write_audio(output_path, out, rate, subtype="PCM_16")
    # a constant gain is exact for integrated loudness, so metering again
    # only adds information when the clip stage engaged
    if clipped:
        output_lufs = calculate_audio_metrics(
            out, rate, device=device, backend=backend)["lufs"]
    else:
        output_lufs = target_lufs
    return {
        "input_lufs": round(lufs, 2),
        "gain_db": round(gain_db, 2),
        "output_lufs": round(output_lufs, 2),
        "clipped": clipped,
        "output": output_path,
    }


def convert(input_path: str, output_path: str, bitrate: str = "256",
            samplerate: int | None = None, device="cuda") -> str:
    """Format conversion (the reference's analyser.py:73-83), with the JAX
    package's targets and tiers: WAV, FLAC (16 bit) and Ogg/Vorbis (at
    ``vorbisenc.quality_for_bitrate(bitrate)``) in-repo, MP3 through
    libmp3lame, AAC / M4A through the FFmpeg libraries, else the ffmpeg
    binary.  ``samplerate`` also rate-converts with ``resample_poly`` on
    ``device`` (the reference's converter changes containers only)."""

    def _read():
        data, rate = wavio.read(input_path)
        if samplerate is None or int(samplerate) == rate:
            return data, rate
        from ..ops.resample import resample_poly

        x = torch.from_numpy(data).to(ensure_device(device))
        return resample_poly(x, int(samplerate), rate).cpu().numpy(), int(samplerate)

    lower = output_path.lower()
    if lower.endswith((".wav", ".flac")):  # PCM16 WAV or 16-bit FLAC
        data, rate = _read()
        wavio.write_audio(output_path, data, rate, subtype="PCM_16")
        return output_path
    if lower.endswith(".ogg"):
        from ..utils import vorbisenc

        data, rate = _read()
        # the encoder is quality-mode (like libvorbis -q): the bitrate asks
        # for a quality through the measured kbps → quality mapping
        vorbisenc.write(output_path, data, rate,
                        quality=vorbisenc.quality_for_bitrate(int(bitrate)))
        return output_path
    if lower.endswith(".mp3"):
        from ..utils import mp3io

        if mp3io.encode_available():
            data, rate = _read()
            mp3io.write(output_path, data, rate, bitrate_kbps=int(bitrate))
            return output_path
        # libmp3lame absent → the ffmpeg tier below keeps the JAX contract
    if lower.endswith((".aac", ".m4a", ".mp4")):
        from ..utils import lavcio

        if lavcio.encode_available():
            data, rate = _read()
            lavcio.encode_aac(output_path, data, rate, bitrate_kbps=int(bitrate))
            return output_path
        # FFmpeg libraries absent → the binary tier below
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found — non-WAV conversion needs ffmpeg on PATH"
        )
    cmd = ["ffmpeg", "-y", "-i", str(input_path), "-b:a", f"{bitrate}k"]
    if samplerate is not None:
        cmd += ["-ar", str(int(samplerate))]
    proc = subprocess.run(cmd + [str(output_path)], capture_output=True, timeout=600)
    if proc.returncode != 0:
        raise ValueError(
            "ffmpeg-Konvertierung fehlgeschlagen: "
            f"{proc.stderr.decode('utf-8', 'replace').strip()[:300]}"
        )
    return output_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ars-analyze", description=__doc__)
    device_help = "torch device (default cuda; cpu runs the plain PyTorch path)"
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="rate/channels/duration/LUFS")
    a.add_argument("input")
    a.add_argument(
        "--true-peak", action="store_true",
        help="also report the 4x oversampled inter-sample true peak (dBTP)",
    )
    a.add_argument("--device", default="cuda", help=device_help)
    a.add_argument("--backend", default="torch", choices=["torch", "oracle"])

    n = sub.add_parser("normalize", help="normalize to target LUFS")
    n.add_argument("input")
    n.add_argument("output")
    n.add_argument("--target", type=float, default=-16.0)
    n.add_argument("--device", default="cuda", help=device_help)
    n.add_argument("--backend", default="torch", choices=["torch", "oracle"])

    c = sub.add_parser(
        "convert", help="convert format (wav/flac/ogg/mp3/aac/m4a, no ffmpeg)"
    )
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--bitrate", default="256")
    c.add_argument("--samplerate", type=int, default=None,
                   help="also rate-convert (polyphase resampler on the device)")
    c.add_argument("--device", default="cuda", help=device_help)

    args = ap.parse_args(argv)
    try:
        if getattr(args, "backend", "torch") != "oracle":
            ensure_device(args.device)  # the oracle meter runs on the host
        if args.cmd == "analyze":
            print(json.dumps(
                analyze(args.input, true_peak=args.true_peak, device=args.device,
                        backend=args.backend),
                ensure_ascii=False, indent=2,
            ))
        elif args.cmd == "normalize":
            print(json.dumps(normalize_to_lufs(args.input, args.output, args.target,
                                               device=args.device,
                                               backend=args.backend), indent=2))
        elif args.cmd == "convert":
            print(convert(args.input, args.output, args.bitrate,
                          samplerate=args.samplerate, device=args.device))
    except Exception as e:  # noqa: BLE001 — CLI error surface
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
