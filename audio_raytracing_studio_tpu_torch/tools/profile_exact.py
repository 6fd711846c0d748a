"""Per-stage table of the exact-mode batched render — port of ``tools/profile_exact.py``.

    python -m audio_raytracing_studio_tpu_torch.tools.profile_exact [--batch 48] \\
        [--seconds 60] [--iters 3] [--device cuda]

On ``bench.py``'s workload (``tools.profile_render.bench_inputs``: Room hall,
Stereo, EQ off, 48 kHz, exact filters) it times the whole render
(``sharding._batched_internal``) and then each stage alone, every stage on
the materialised output of the stage before it:

- ``ir_synth``: the bank, ``ops.ir_synth_cuda.fused_rir_bank`` (the CUDA
  kernels on a card);
- ``conv``: ``convolution.convolve_full`` of the clips with both IRs;
- ``exact_air``: ``filters.apply_air_absorption`` on the late stream at the
  exact output length (cuFFT at n = len_out = 2,951,999 for 60 s);
- ``mix``: the level-weighted wet sum, the dry/wet mix and the conditional
  normalize (the first half of ``pipeline._mix_eq_spatial``, EQ off);
- ``pan_map``: the 2→6 pan, normalize, the layout map, normalize (its
  second half);
- ``meter``: ``metering.loudness.audio_metrics`` on the output (not part of
  the bench's render, so not in ``stage_sum_s``).

Consumed intermediates are freed between stages.  Two transform units time
what the port's FFT-bound stages run: ``unit_rfft_pair_s`` (rfft + irfft of
(B, 2, conv grid)) and ``unit_exact_rfft_pair_s`` (rfft + irfft of
(B, 2, len_out), the cuFFT transform ``apply_air_absorption`` runs).  The JAX
tool's ``unit_cfft_pair`` timed the TPU's radix-3 complex transform over the
air filter's wrap grid, a workaround the port does not carry (cuFFT takes
the exact length directly), so it has no counterpart.

Each stage has a bytes bound beside it (``*_bound_s``): the bytes the stage
must read and write — each of its materialised inputs read once, each
output written once — over 3.35 TB/s (the H100 SXM's HBM3 rate).
``chain_max_abs_err`` is the max-abs between the stage chain's output and
the whole render's.  Stage times come from CUDA events on a card (the host
clock, synchronized, on the CPU).  Prints one JSON line naming the device;
without a CUDA device, and without ``--device cpu``, it prints the line with
an ``"error"`` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
METRIC = "exact_render_stage_table"


def stage_s(fn, iters: int, device) -> float:
    """Mean seconds per call of ``fn`` after one warm-up call: CUDA events
    on a card, the synchronized host clock elsewhere."""
    if torch.device(device).type == "cuda":
        from .profile_render import event_ms

        return event_ms(fn, iters) / 1e3
    from ..utils.profiling import time_call

    return time_call(fn, iterations=iters, device=device).seconds_per_call


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile(batch: int = 48, seconds: float = 60.0, iters: int = 3, device="cuda") -> dict:
    """Time the stage chain → the table's figures (seconds)."""
    from ..metering import loudness
    from ..models.pipeline import _col
    from ..ops import convolution, filters, spatial
    from ..ops.ir_synth_cuda import fused_rir_bank
    from .profile_render import RATE, bench_clips, bench_inputs

    inputs = bench_inputs(bench_clips(batch, seconds), False, device)
    audio, seeds, ir_sc, mix = inputs.audio, inputs.seeds, inputs.ir_scalars, inputs.mix
    spec, shape = inputs.setup.spec, inputs.setup.ir_shape
    if not (spec.early_on and spec.late_on and spec.air_on) or spec.eq_on or spec.fast_air:
        raise ValueError(f"the stage chain expects the bench's exact configuration, got {spec}")
    len_out, n_in = spec.len_out, spec.n_in
    table = {}
    bounds = {}

    def stage(name, fn, inputs_, outputs_):
        table[f"{name}_s"] = stage_s(fn, iters, device)
        bounds[f"{name}_bound_s"] = nbytes(*inputs_, *outputs_) / PEAK_BYTES_S

    full = inputs.render()
    stage("full_exact_graph", inputs.render, [audio], [full])

    early, late = fused_rir_bank(seeds, shape, ir_sc)
    stage("ir_synth", lambda: fused_rir_bank(seeds, shape, ir_sc), [seeds], [early, late])

    kernels = torch.stack([early, late], dim=1)
    del early, late
    conv = convolution.convolve_full(audio, kernels, len_out)
    stage("conv", lambda: convolution.convolve_full(audio, kernels, len_out),
          [audio, kernels], [conv])
    early_wet = conv[:, 0].contiguous()
    late_wet = conv[:, 1].contiguous()
    del conv, kernels

    late_aired = filters.apply_air_absorption(late_wet, RATE, mix.air_absorption)
    stage("exact_air", lambda: filters.apply_air_absorption(late_wet, RATE, mix.air_absorption),
          [late_wet], [late_aired])
    del late_wet

    dry = torch.nn.functional.pad(audio, (0, len_out - n_in))
    del audio

    def mix_stage():
        wet = early_wet * _col(mix.early_level) + late_aired * _col(mix.late_level)
        mixed = _col(mix.dry_factor * (1.0 - mix.dry_wet)) * dry + _col(mix.dry_wet) * wet
        return filters.conditional_peak_normalize(mixed)

    mixed = mix_stage()
    stage("mix", mix_stage, [dry, early_wet, late_aired], [mixed])
    del dry, early_wet, late_aired

    def pan_stage():
        six = spatial.apply_pan(mixed, spatial.pan_matrix(mix.x_pos, mix.y_pos, mix.z_pos))
        six = filters.conditional_peak_normalize(six)
        out = spatial.map_layout(six, spec.layout, spec.rate, mix.z_pos)
        return filters.conditional_peak_normalize(out)

    out = pan_stage()
    stage("pan_map", pan_stage, [mixed], [out])
    del mixed
    chain_err = float((out - full).abs().max())
    del full

    stage("meter", lambda: loudness.audio_metrics(out, RATE), [out], [])
    del out

    grid = convolution.fast_fft_length(n_in + shape.length - 1)
    for name, n in (("unit_rfft_pair", grid), ("unit_exact_rfft_pair", len_out)):
        x = torch.randn((batch, 2, n), device=device,
                        generator=torch.Generator(device).manual_seed(0))

        def pair(x=x, n=n):
            return torch.fft.irfft(torch.fft.rfft(x, n=n), n=n)

        stage(name, pair, [x], [x])
        del x

    stage_sum = sum(table[f"{k}_s"] for k in ("ir_synth", "conv", "exact_air", "mix", "pan_map"))
    return {
        **table,
        "stage_sum_s": stage_sum,
        "realtime_factor_exact": batch * seconds / table["full_exact_graph_s"],
        "chain_max_abs_err": chain_err,
        **bounds,
        "batch": batch, "clip_s": seconds, "iters": iters, "rate": RATE, "n_in": n_in,
        "ir_length": shape.length, "len_out": len_out, "conv_grid": grid,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=60.0, help="seconds per clip")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    from .bench_long import card, needs_card

    error = needs_card(args.device)
    if error:
        print(json.dumps({"metric": METRIC, "error": error}))
        return 1
    figures = profile(args.batch, args.seconds, args.iters, args.device)
    print(json.dumps({"metric": METRIC, **figures, "device": card(args.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
