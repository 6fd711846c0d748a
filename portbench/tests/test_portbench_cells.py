"""Every cell of BENCHMARK.json resolves by name to its files, and the file
keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from portbench import run as bench
from portbench.harness import reference

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in SPEC["paths"])


def test_names_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    # at most a quarter of the cells, rounded down, take four chips, or one cell may
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    spec = bench.cell_spec(workload)
    assert spec["config"]["name"] == spec["cell"]["config"]
    # the plain reference the configuration names (the internal hall by default)
    assert callable(reference(spec["config"]).render_row)
    assert hasattr(bench.generator(spec["traffic"]), "run")
    e2e = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
        # each metric that a cell reports moves an end-to-end metric the cell reports
        assert m["moves"] in e2e
    assert "pcm_gap_lsb" in spec["limits"]
    assert set(spec["limits"]) <= {"pcm_gap_lsb", "lufs_gap_lu", "peak_gap_db", "rms_gap_db"}
