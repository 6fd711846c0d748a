"""``tools/bench_serving.py`` on the CPU: each mode — the burst, ``--soak``,
``--matrix --soak`` (its mesh arms on a mesh of two CPU shards too) and
``--http --soak`` — runs in this process at a tiny
size and prints its JSON line with no failed job (every result of its true
length and not silent).  The soak modes run short clips off the
half-second grid (0.3 and 0.7 s) and warm one bucket, so the arrivals are
many and the warm-up is short.  The HTTP soak's uploads and results cycle
through WAV, FLAC and Ogg, or WAV alone with ``--http-formats wav``."""

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
    ("matrix-mesh", ["--matrix", "--soak", "1", "--mesh-devices", "2"] + SOAK),
    ("http", ["--http", "--soak", "2"] + SOAK),
    ("http-wav", ["--http", "--soak", "2", "--http-formats", "wav"] + SOAK),
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
    elif mode == "matrix-mesh":
        # the mesh arms over ["cpu"] * 2: the plain IR path and the bank per shard
        names = ["bank+extir", "jnp", "mesh", "bank-mesh"]
        assert [a["arm"] for a in lines[:-1]] == [a["arm"] for a in line["arms"]] == names
        assert all(a["failed"] == 0 and a["completed"] > 0 for a in line["arms"])
    else:
        assert line["completed"] == line["submitted"] > 0
        assert line["rejected_503"] == 0
        assert "latency_p99_s" in line and "rss_peak_mb" in line and "pinned_end_mb" in line
    if mode == "soak":
        assert sum(line["dispatch_size_hist"].values()) > 0
    if mode.startswith("http"):
        formats = ["wav"] if mode == "http-wav" else ["wav", "flac", "ogg"]
        assert line["formats"] == formats  # uploads and results
        assert line["mix"]["upload_codecs"] == line["mix"]["result_formats"] == formats
        assert line["upload_files_end"] <= 64  # the service's upload cap
        assert set(line["split_s"]) == set(bench_serving.HTTP_SPLIT)
        slowest = line["slowest"]
        walls = [job["latency_s"] for job in slowest]
        assert 0 < len(slowest) <= 3 and walls == sorted(walls, reverse=True)
        for job in slowest:  # the split adds up to the job's wall
            assert job["codec"] in formats and job["format"] in formats
            assert abs(sum(job[k] for k in bench_serving.HTTP_SPLIT) - job["latency_s"]) < 1e-6


def test_http_mix_crosses_lengths_codecs_and_formats():
    durations, codecs = [5.3, 14.7, 44.9], ["wav", "flac", "ogg"]
    jobs = [bench_serving.http_mix(i, durations, codecs) for i in range(27)]
    assert sorted(jobs) == sorted({(d, c, f) for d in durations for c in codecs for f in codecs})
    assert jobs[:4] == [(5.3, "wav", "wav"), (14.7, "wav", "wav"), (44.9, "wav", "wav"),
                        (5.3, "flac", "wav")]
    assert bench_serving.http_mix(30, durations, ["wav"]) == (5.3, "wav", "wav")


def test_result_fault_names_length_and_silence():
    import numpy as np

    assert bench_serving.result_fault(np.ones((10, 2), np.int16), 10) is None
    assert bench_serving.result_fault(np.ones((9, 2), np.int16), 10) == "length 9 != 10"
    assert bench_serving.result_fault(np.zeros((10, 2), np.int16), 10) == "silent"
