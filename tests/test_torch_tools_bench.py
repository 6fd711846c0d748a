"""The port's bench line (``tools/bench.py``) and ``tools/bench_long.py``'s
bank mode on the CPU, and the no-fallback rule of every new tool.

- The bench's timed computation — ``sharding._batched_internal`` on the
  bench batch, fast and exact — equals the JAX package's
  ``_batched_internal`` on the same clips, seeds and params within 2e-5
  (float round-off between two FFT libraries; the bound the port's renders
  meet everywhere);
- its JSON line has the JAX bench's keys plus the settle fields and the
  device;
- ``settle_and_median`` flags a settle loop that ran out (a fake clock whose
  samples never agree within 20%) and not one that settled;
- the bank mode's two renders (the bank's IRs and the plain IR path's)
  agree within 1e-4 (``chip_smoke.py`` phase 10c's bound);
- without a card and without ``--device cpu`` each tool prints one JSON line
  with an ``"error"`` and exits 1.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.models import pipeline as jpipeline
from audio_raytracing_studio_tpu.parallel import sharding as jsharding
from audio_raytracing_studio_tpu.params import RenderParams as JaxParams
from audio_raytracing_studio_tpu_torch.tools import (bench, bench_long, bench_serving,
                                                     fuzz_campaign, profile_exact)
from audio_raytracing_studio_tpu_torch.tools.profile_render import RATE, bench_clips

torch.set_num_threads(1)

BATCH, SECONDS = 2, 0.5
TOL = 2e-5


def jax_batched_internal(clips, fast):
    """bench.py's timed call on these clips, in the JAX package."""
    batch = clips.shape[0]
    setup = jpipeline.build_internal_setup(JaxParams(target_layout="Stereo"), RATE,
                                           clips.shape[1], fast_filters=fast)
    audio = jnp.asarray(np.stack([jpipeline._ensure_stereo_host(c).T for c in clips]))
    bcast = lambda x: jnp.broadcast_to(x, (batch,))  # noqa: E731
    out, _ = jsharding._batched_internal(
        audio, jnp.arange(batch, dtype=jnp.int32),
        jax.tree.map(bcast, setup.ir_scalars), jax.tree.map(bcast, setup.mix_scalars),
        ir_shape=setup.ir_shape, spec=setup.spec, with_metrics=False,
    )
    return np.asarray(out)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_timed_computation_equals_the_jax_bench(fast, record_property):
    ours = bench.workload(BATCH, SECONDS, fast, device="cpu")().numpy()
    ref = jax_batched_internal(bench_clips(BATCH, SECONDS), fast)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    record_property("max_abs_vs_jax", err)
    assert err <= TOL


def test_line_has_the_jax_keys_and_the_settle_fields(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_SETTLE_MAX", "2")
    assert bench.main(["--batch", str(BATCH), "--seconds", str(SECONDS), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "value_exact", "vs_baseline_exact",
                "settled_fast", "settled_exact", "settle_s_fast", "settle_s_exact"):
        assert key in line, key
    assert line["metric"] == "realtime_factor_60s48k_batched_per_chip"
    assert line["value"] > 0 and line["value_exact"] > 0
    assert isinstance(line["settled_fast"], bool) and isinstance(line["settled_exact"], bool)
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.baseline_rtf())
    assert line["device"] == {"name": "cpu"}
    assert "last_measured_on_tpu" not in line


def fake_clock(durations):
    """A clock under which each ``run()`` takes the next of ``durations``."""
    state = {"t": 0.0, "i": 0}

    def run():
        state["t"] += durations[min(state["i"], len(durations) - 1)]
        state["i"] += 1

    return run, lambda: state["t"]


def test_settle_loop_that_runs_out_is_flagged():
    # the warm-up, then samples alternating 1 s and 2 s: no two agree within 20%
    run, clock = fake_clock([5.0] + [1.0, 2.0] * 10)
    result = bench.settle_and_median(run, lambda: None, settle_max=6, samples=3, clock=clock)
    assert result["settled"] is False
    assert result["settle_runs_s"] == [1.0, 2.0, 1.0, 2.0, 1.0, 2.0]
    assert result["settle_s"] == pytest.approx(9.0)
    assert result["runs_s"] == [1.0, 1.0, 2.0] and result["wall_s"] == 1.0


def test_settle_loop_that_agrees_is_not_flagged():
    run, clock = fake_clock([5.0, 3.0, 1.0, 1.1, 1.0, 0.9, 1.2])
    result = bench.settle_and_median(run, lambda: None, settle_max=12, samples=3, clock=clock)
    assert result["settled"] is True
    assert result["settle_runs_s"] == pytest.approx([3.0, 1.0, 1.1])
    assert result["wall_s"] == pytest.approx(1.0)


def test_bank_mode_renders_agree(capsys):
    assert bench_long.main(["bank", "--batch", "2", "--seconds", "0.25", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "cathedral600_60s48k_compute_realtime_factor"
    assert line["ir_length"] == 346809  # Cathedral, room size 600, 48 kHz
    assert line["ir_backend_bank"] > 0 and line["ir_backend_jnp"] > 0
    assert line["max_abs_bank_vs_jnp"] <= 1e-4
    assert line["device"] == {"name": "cpu"}


NO_CARD = [
    ("bench", bench.main, []),
    ("profile_exact", profile_exact.main, []),
    ("bench_long long", bench_long.main, ["long", "--minutes", "0.01"]),
    ("bench_long bank", bench_long.main, ["bank"]),
    ("bench_serving burst", bench_serving.main, []),
    ("bench_serving soak", bench_serving.main, ["--soak", "1"]),
    ("bench_serving matrix", bench_serving.main, ["--matrix", "--soak", "1"]),
    ("bench_serving http", bench_serving.main, ["--http", "--soak", "1"]),
    ("fuzz parity", fuzz_campaign.main, ["parity", "1"]),
    ("fuzz preset", fuzz_campaign.main, ["preset", "1"]),
]


@pytest.mark.parametrize("name,main,argv", NO_CARD, ids=[n for n, _, _ in NO_CARD])
def test_no_card_prints_an_error_line_and_exits_1(name, main, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    assert main(argv) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert "CUDA" in line["error"]
