"""``tools/profile_exact.py`` on the CPU: its stage chain (bank → conv →
exact air → mix → pan and map, each stage on the materialised output of
the one before) reproduces the whole exact render within 1e-5 (the same
operations in the same order; ``chip_smoke.py`` phase 10b's bound), and its
line carries the JAX tool's stage keys, the port's transform units and a
bytes bound beside each stage."""

import json

import pytest
import torch

from audio_raytracing_studio_tpu_torch.tools import profile_exact

torch.set_num_threads(1)

STAGES = ("full_exact_graph", "ir_synth", "conv", "exact_air", "mix", "pan_map", "meter",
          "unit_rfft_pair", "unit_exact_rfft_pair")


@pytest.fixture(scope="module")
def line():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_exact.main(["--batch", "2", "--seconds", "0.5", "--iters", "1",
                                 "--device", "cpu"])
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_stage_chain_reproduces_the_whole_render(line, record_property):
    record_property("chain_max_abs_err", line["chain_max_abs_err"])
    assert line["chain_max_abs_err"] <= 1e-5


def test_keys_and_bytes_bounds(line):
    for stage in STAGES:
        assert line[f"{stage}_s"] > 0, stage
        assert line[f"{stage}_bound_s"] > 0, stage
    assert "unit_cfft_pair_s" not in line  # the TPU's radix-3 transform: no counterpart
    assert line["stage_sum_s"] == pytest.approx(sum(
        line[f"{k}_s"] for k in ("ir_synth", "conv", "exact_air", "mix", "pan_map")))
    assert line["realtime_factor_exact"] == pytest.approx(2 * 0.5 / line["full_exact_graph_s"])
    n_in, len_out = 24000, 24000 + 72000 - 1
    assert (line["n_in"], line["ir_length"], line["len_out"]) == (n_in, 72000, len_out)
    assert line["conv_grid"] == 98304  # 3 · 2^15 ≥ len_out
    # the exact air reads and writes (B, 2, len_out) float32 once each
    assert line["exact_air_bound_s"] == pytest.approx(2 * 2 * 2 * len_out * 4 / 3.35e12)
    assert line["device"] == {"name": "cpu"}


def test_the_chain_refuses_another_configuration(monkeypatch):
    from audio_raytracing_studio_tpu_torch import RenderParams
    from audio_raytracing_studio_tpu_torch.tools import profile_render

    real = profile_render.bench_inputs

    def with_eq(clips, fast, device="cuda", params=None):
        return real(clips, fast, device, RenderParams(target_layout="Stereo", bass_gain=1.5))

    monkeypatch.setattr(profile_render, "bench_inputs", with_eq)
    with pytest.raises(ValueError, match="exact configuration"):
        profile_exact.profile(batch=1, seconds=0.1, iters=1, device="cpu")
