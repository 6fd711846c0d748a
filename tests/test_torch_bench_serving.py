"""``tools/bench_serving.py`` on the CPU: each mode — the burst, ``--soak``,
``--matrix --soak`` and ``--http --soak`` — runs in this process at a tiny
size and prints its JSON line with no failed job (every result of its true
length and not silent).  The soak modes run short clips off the
half-second grid (0.3 and 0.7 s) and warm one bucket, so the arrivals are
many and the warm-up is short."""

import json

import pytest
import torch

from audio_raytracing_studio_tpu_torch.tools import bench_serving

torch.set_num_threads(1)

BASE = ["--jobs", "4", "--seconds", "0.5", "--rate", "16000", "--device", "cpu"]
SOAK = ["--soak-durations", "0.3,0.7", "--warm-buckets", "2", "--arrival-rate", "4"]

MODES = [
    ("burst", []),
    ("soak", ["--soak", "2"] + SOAK),
    ("matrix", ["--matrix", "--soak", "1"] + SOAK),
    ("http", ["--http", "--soak", "2"] + SOAK),
]


@pytest.mark.parametrize("mode,argv", MODES, ids=[m for m, _ in MODES])
def test_mode_prints_its_line_with_no_failed_job(mode, argv, capsys):
    assert bench_serving.main(BASE + argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    line = lines[-1]
    assert line["failed"] == 0
    assert line["device"] == {"name": "cpu"}
    if mode == "burst":
        assert line["jobs"] == 4 and line["value"] > 0
        assert line["metric"] == bench_serving.BURST_METRIC
    elif mode == "matrix":
        arms = {a["arm"]: a for a in line["arms"]}
        assert arms["bank+extir"]["failed"] == arms["jnp"]["failed"] == 0
        assert arms["bank+extir"]["completed"] > 0 and arms["jnp"]["completed"] > 0
        assert arms["mesh"]["skipped"] == arms["bank-mesh"]["skipped"] == bench_serving.MESH_SKIPPED
        assert [a["arm"] for a in lines[:-1]] == ["bank+extir", "jnp"]
    else:
        assert line["completed"] == line["submitted"] > 0
        assert line["rejected_503"] == 0
        assert "latency_p99_s" in line and "rss_peak_mb" in line and "pinned_end_mb" in line
    if mode == "soak":
        assert sum(line["dispatch_size_hist"].values()) > 0
    if mode == "http":
        assert line["formats"] == ["wav"]
        assert line["upload_files_end"] <= 64  # the service's upload cap


def test_result_fault_names_length_and_silence():
    import numpy as np

    assert bench_serving.result_fault(np.ones((10, 2), np.int16), 10) is None
    assert bench_serving.result_fault(np.ones((9, 2), np.int16), 10) == "length 9 != 10"
    assert bench_serving.result_fault(np.zeros((10, 2), np.int16), 10) == "silent"
