"""A whole run of each cell on the CPU at a tiny size: the result line's
keys, the reference agreeing with the program, and no JAX in the process."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as bench
from portbench.tests.conftest import TINY

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace):
    line = bench.run_cell(workload, 2 ** 31 + 17, 0.3, trace, "cpu", TINY)
    line.pop("_setup_split")
    line.pop("_counters")
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["check"]
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for c in line["check"].values():
        assert c["value"] <= c["limit"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_process_holds_no_jax():
    """What a run imports, compared by whole top-level name (the port's name
    begins with the JAX package's)."""
    code = (
        "from portbench import run as bench\n"
        "from portbench.harness import offending_modules\n"
        "from portbench.tests.conftest import TINY\n"
        f"for w in {CELLS!r}:\n"
        "    spec = bench.cell_spec(w)\n"
        "    [bench.reader(m['name']) for m in spec['per_layer']]\n"
        "    bench.run_cell(w, 3, 0.2, False, 'cpu', TINY)\n"
        "import sys\n"
        "print(offending_modules(), sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[2], timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    bad, tops = out.stdout.strip().splitlines()[-1].split("] ", 1)
    assert bad == "[", out.stdout
    assert "audio_raytracing_studio_tpu_torch" in tops


def test_bank_roofline_reads_the_windows_bank_kernels(monkeypatch):
    """The bank's share comes from its two kernels' time and launches in the
    traced window; other kernels do not enter it."""
    import types

    from portbench import roofline

    monkeypatch.setattr(roofline, "hbm_bytes_per_s", lambda device: 1e12)
    spec = bench.cell_spec(CELLS[0])
    run = types.SimpleNamespace(
        device="cuda",
        cell=dict(batch=48, rate=48000, params=spec["config"]["params"]),
        trace_summary={"by_name": {
            "void bank_stats_kernel<false, 4>(float const*)": (0.002, 10),
            "void bank_write_kernel<false, 4>(float*)": (0.018, 10),
            "void vector_fft<4096>(float2*)": (9.0, 500)}})
    length = 72000  # the Room hall's IR at 48 kHz
    nbytes = 2 * 48 * length * 4 + 48 * 4 + 48 * 16
    assert bench.reader("bank_roofline")(run) == pytest.approx(100 * nbytes / 1e12 / 0.002)
    run.trace_summary = {"by_name": {"void vector_fft<4096>(float2*)": (9.0, 500)}}
    assert bench.reader("bank_roofline")(run) is None
