"""The port's two-process dry run (``tools/dryrun_distributed.py``) on the CPU:
two processes in one gloo group, each rendering four rows over a local mesh
of two shards; process 0 gathers the batch.  The gathered result and
metrics must equal a one-process render of the same eight rows bit for bit
(one thread everywhere)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu_torch.parallel import sharding
from audio_raytracing_studio_tpu_torch.tools import dryrun_distributed as dd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_render_equals_one_process(tmp_path):
    saved = tmp_path / "gathered.npz"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "audio_raytracing_studio_tpu_torch.tools.dryrun_distributed",
         "--device", "cpu", "--save", str(saved), "--timeout", "100"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads([l for l in proc.stdout.splitlines() if l.startswith("{")][-1])
    assert line["ok"] is True
    assert line["processes"] == 2 and line["global_devices"] == 4
    assert line["out_shape"][0] == line["batch"] == dd.BATCH
    assert line["device"] == {"name": "cpu"}

    gathered = np.load(saved)
    rows = list(range(dd.BATCH))
    want, metrics = sharding.render_batch(dd.clips(rows), dd.RATE, dd.params(), seeds=rows,
                                          with_metrics=True, device="cpu")
    assert np.array_equal(gathered["out"], want)
    table = np.asarray([[m[k] for k in dd.METRIC_KEYS] for m in metrics], np.float64)
    assert np.array_equal(gathered["metrics"], table)


def test_dry_run_needs_a_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    assert dd.main([]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] is False and "CUDA" in line["error"]
