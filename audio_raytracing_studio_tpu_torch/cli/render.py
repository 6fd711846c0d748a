"""Headless renderer — port of ``audio_raytracing_studio_tpu/cli/render.py``.

Renders one clip, a parameter sweep (one batch) or a binaural downmix from
the command line, with presets (v4 JSON) or flags.  It runs on the CUDA
device unless ``--device cpu`` is given; without a card a CUDA run exits
with an error and never moves to the CPU by itself.

Examples:
  python -m audio_raytracing_studio_tpu_torch.cli.render in.wav out.wav \
      --hall Cathedral --room-size 400 --layout "5.1 (Standard)" --metrics
  python -m audio_raytracing_studio_tpu_torch.cli.render in.wav out_{i}.wav \
      --preset my_hall_v4.json --sweep diffusion=0.1,0.5,0.9 --seed 7

  python -m audio_raytracing_studio_tpu_torch.cli.render long.wav out.wav \
      --stream --chunk-seconds 30 --layout "5.1 (Standard)" --metrics

Inputs are anything ``utils.wavio.read`` reads (WAV, AIFF, FLAC, Ogg/Vorbis,
MP3, AAC / M4A); the output's extension picks its encoder (``wavio.
write_audio``: .flac, .ogg, .mp3, .aac / .m4a, anything else WAV).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np

from .. import config
from ..analysis.metrics import calculate_audio_metrics, metrics_string
from ..params import RenderParams
from ..utils import wavio
from ..utils.presets import PresetStore
from ..utils.runtime import ensure_device

# z_pos is NOT sweepable: it scales max_early_delay and therefore the IR
# shape (params.adjust_parameters_for_3d), which must match across a batch.
SWEEPABLE = (
    "diffusion", "air_absorption", "early_level", "late_level", "dry_wet",
    "dry_wet_kill_start", "bass_gain", "treble_gain", "x_pos", "y_pos",
)
# external-IR mode has no hall synthesis: only mix/EQ/position apply
EXTERNAL_SWEEPABLE = (
    "dry_wet", "dry_wet_kill_start", "bass_gain", "treble_gain", "x_pos", "y_pos",
)


def add_param_flags(ap: argparse.ArgumentParser) -> None:
    """The shared render-parameter flag set (reused by render_dir)."""
    ap.add_argument("--preset", help="v4 preset JSON filename (from --preset-dir)")
    ap.add_argument("--preset-dir", default=".", help="directory containing presets_v4/")
    ap.add_argument("--hall", choices=list(config.HALL_PRESETS), help="hall type")
    ap.add_argument("--material", choices=list(config.MATERIAL_ABSORPTION))
    ap.add_argument("--layout", choices=list(config.CHANNEL_LAYOUTS))
    ap.add_argument("--room-size", type=float)
    ap.add_argument("--diffusion", type=float)
    ap.add_argument("--air-absorption", type=float)
    ap.add_argument("--early-level", type=float)
    ap.add_argument("--late-level", type=float)
    ap.add_argument("--dry-wet", type=float)
    ap.add_argument("--kill-start", type=float)
    ap.add_argument("--bass-gain", type=float)
    ap.add_argument("--treble-gain", type=float)
    ap.add_argument("--x", type=float, dest="x_pos")
    ap.add_argument("--y", type=float, dest="y_pos")
    ap.add_argument("--z", type=float, dest="z_pos")
    ap.add_argument("--external-ir", help="stereo IR WAV (switches to external mode)")
    ap.add_argument("--seed", type=int, default=0, help="deterministic render seed")
    ap.add_argument("--metrics", action="store_true", help="print LUFS/Peak/RMS")
    ap.add_argument(
        "--binaural", action="store_true",
        help="post-process the surround render to binaural stereo for "
        "headphones (spherical-head ITD/ILD model)",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default cuda; cpu runs the plain "
        "PyTorch path)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ars-render",
        description="Audio Raytracing Studio — headless renderer (PyTorch / CUDA)",
    )
    ap.add_argument("input", help="input audio file (WAV/FLAC/AIFF/OGG/MP3/AAC/M4A)")
    ap.add_argument(
        "output",
        help="output file; .flac/.ogg target the in-repo encoders, "
        ".mp3/.aac/.m4a the system codec libraries, anything else writes "
        "WAV; use {i} for sweep index",
    )
    add_param_flags(ap)
    ap.add_argument(
        "--sweep",
        help=f"param sweep 'name=v1,v2,...' over one of {SWEEPABLE} "
        "(rendered as one batch)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="chunked streaming render for long clips (no whole-clip convolution FFT)",
    )
    ap.add_argument(
        "--chunk-seconds", type=float, default=30.0,
        help="streaming chunk size in seconds (with --stream)",
    )
    return ap


def params_from_args(args) -> RenderParams:
    p = RenderParams()
    if args.preset:
        try:
            p = PresetStore(args.preset_dir).load(args.preset)
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot load preset: {e}") from e
    overrides = {
        "hall_type": args.hall,
        "material": args.material,
        "target_layout": args.layout,
        "room_size": args.room_size,
        "diffusion": args.diffusion,
        "air_absorption": args.air_absorption,
        "early_level": args.early_level,
        "late_level": args.late_level,
        "dry_wet": args.dry_wet,
        "dry_wet_kill_start": args.kill_start,
        "bass_gain": args.bass_gain,
        "treble_gain": args.treble_gain,
        "x_pos": args.x_pos,
        "y_pos": args.y_pos,
        "z_pos": args.z_pos,
    }
    overrides = {k: v for k, v in overrides.items() if v is not None}
    for k, v in overrides.items():
        # argparse type=float parses "nan"/"inf"; a NaN diffusion breaks the
        # IR geometry and NaN positions render garbage — the CLI boundary
        # rejects non-finite values
        if isinstance(v, float) and not math.isfinite(v):
            raise ValueError(f"--{k.replace('_', '-')} must be finite (got {v})")
    if args.external_ir:
        overrides["use_external_ir"] = True
    return dataclasses.replace(p, **overrides)


def _format_output(template: str, i: int) -> str:
    """Fill the {i} placeholder; paths with other literal braces pass through."""
    try:
        return template.format(i=i)
    except (KeyError, IndexError, ValueError):
        return template


def _finalize_and_write(out, out_path, rate, args, layout, metrics):
    """Binauralize when asked, clip to the output contract, write — one
    implementation for the sweep and plain branches.  With --binaural the
    reported metrics are measured again on the binaural stereo actually
    written (the surround metrics would describe a signal that never hits
    disk)."""
    out = np.asarray(out)
    if args.binaural:
        from ..ops.binaural import binauralize

        out = binauralize(out.astype(np.float32, copy=False), rate, layout, device=args.device)
        out = np.clip(out, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
        if metrics is not None:
            metrics = calculate_audio_metrics(out, rate, device=args.device)
    elif out.dtype != np.int16:  # int16 = device-quantized, already clipped
        out = np.clip(out, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
    wavio.write_audio(out_path, out, rate)
    return metrics


def _json_safe(obj):
    """json.dumps emits RFC-8259-invalid '-Infinity' for non-finite floats
    (silent renders meter at lufs=-inf); map them to sentinel strings."""
    if isinstance(obj, float) and not np.isfinite(obj):
        if np.isnan(obj):
            return "nan"
        return "inf" if obj > 0 else "-inf"
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        ensure_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        audio, rate = wavio.read(args.input)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {args.input}: {e}", file=sys.stderr)
        return 1
    try:
        base_params = params_from_args(args)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    external_ir = external_rate = None
    if args.external_ir:
        try:
            external_ir, external_rate = wavio.read(args.external_ir)
        except (OSError, ValueError) as e:
            print(f"error: cannot read {args.external_ir}: {e}", file=sys.stderr)
            return 1

    # the meter is a full extra device pass — only pay for it when the
    # numbers are actually reported
    want_metrics = args.metrics or args.json
    results = []
    if args.sweep and args.stream:
        # the sweep path batches whole-clip renders in memory — silently
        # dropping --stream would defeat the reason it was passed
        print(
            "error: --stream cannot be combined with --sweep (sweeps render "
            "whole clips in device memory; run one streaming render per value)",
            file=sys.stderr,
        )
        return 2
    if args.sweep:
        if _format_output(args.output, 0) == _format_output(args.output, 1):
            # behavioral check: any usable placeholder ({i}, {i:03d}, …)
            # makes consecutive indices expand to distinct paths
            print(
                "error: sweep output path needs an '{i}' placeholder "
                "(e.g. out_{i}.wav) — otherwise every sweep value would "
                "overwrite the same file",
                file=sys.stderr,
            )
            return 2
        name, _, values_str = args.sweep.partition("=")
        if name not in SWEEPABLE:
            print(f"error: sweep over '{name}' not supported (shape-changing)", file=sys.stderr)
            return 2
        if base_params.use_external_ir and name not in EXTERNAL_SWEEPABLE:
            print(
                f"error: '{name}' has no effect in external-IR mode "
                f"(sweepable there: {EXTERNAL_SWEEPABLE})",
                file=sys.stderr,
            )
            return 2
        try:
            values = [float(v) for v in values_str.split(",") if v.strip()]
        except ValueError:
            print(
                f"error: sweep values must be numbers (got '{values_str}')",
                file=sys.stderr,
            )
            return 2
        if not values:
            print(
                f"error: sweep over '{name}' needs at least one value "
                "(e.g. --sweep diffusion=0.2,0.8)",
                file=sys.stderr,
            )
            return 2
        from ..parallel.sharding import render_batch

        param_list = [dataclasses.replace(base_params, **{name: v}) for v in values]
        clips = np.stack([audio] * len(values))
        try:
            res = render_batch(
                clips, rate, param_list,
                seeds=[args.seed] * len(values), with_metrics=want_metrics,
                external_ir=external_ir, external_ir_rate=external_rate,
                device=args.device,
            )
            outs, metrics = res if want_metrics else (res, None)
            for i, v in enumerate(values):
                out_path = _format_output(args.output, i)
                m = _finalize_and_write(
                    outs[i], out_path, rate, args, base_params.target_layout,
                    metrics[i] if metrics is not None else None,
                )
                results.append({"output": out_path, name: v, "metrics": m})
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.stream:
        from ..parallel.streaming import render_streaming

        try:
            # without the binaural downmix the output contract is PCM16, so
            # quantize on the device: half the bytes come down
            res = render_streaming(
                audio, rate, base_params, seed=args.seed,
                chunk_seconds=args.chunk_seconds, with_metrics=want_metrics,
                external_ir=external_ir, external_ir_rate=external_rate,
                pcm16_output=not args.binaural,
                # the single-clip CLI contract is the exact filter stack
                # (pipeline.render's default)
                fast_filters=False, device=args.device,
            )
            out, metrics = res if want_metrics else (res, None)
            out_path = _format_output(args.output, 0)
            metrics = _finalize_and_write(
                out, out_path, rate, args, base_params.target_layout, metrics
            )
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        results.append({"output": out_path, "metrics": metrics})
    else:
        from ..models import pipeline

        try:
            res = pipeline.render(
                audio, rate, base_params, seed=args.seed,
                external_ir=external_ir, external_ir_rate=external_rate,
                return_metrics=want_metrics, device=args.device,
            )
            out, metrics = res if want_metrics else (res, None)
            out_path = _format_output(args.output, 0)
            metrics = _finalize_and_write(
                out, out_path, rate, args, base_params.target_layout, metrics
            )
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        results.append({"output": out_path, "metrics": metrics})

    if args.json:
        print(json.dumps(_json_safe(results)))
    else:
        for r in results:
            line = r["output"]
            if args.metrics and r.get("metrics") is not None:
                line += "  " + metrics_string(r["metrics"])
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
