"""``tools/fuzz_campaign.py`` on the CPU: every mode at two cases (seeds
1000-1001) ends with no finding and exit 0, and a render made wrong by
2e-3 on purpose is reported by ``parity`` and turns the exit code non-zero.

The torch CPU path renders bit for bit alike only at a fixed thread count
(its FFT and reductions split their work by thread), and the ``batch`` and
``streaming`` modes hold a PCM16 render to the quantized float render of a
second call: this file pins one thread, as the other port tests do.
"""

import json

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.tools import fuzz_campaign

torch.set_num_threads(1)


def run(mode, cases, findings, capsys, *extra):
    rc = fuzz_campaign.main([mode, str(cases), "--device", "cpu", "--findings",
                             str(findings), *extra])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, summary


@pytest.mark.parametrize("mode", list(fuzz_campaign.MODES))
def test_mode_finds_nothing(mode, tmp_path, capsys):
    findings = tmp_path / "findings.jsonl"
    rc, summary = run(mode, 2, findings, capsys)
    assert summary["findings"] == 0, findings.read_text() if findings.exists() else summary
    assert rc == 0
    assert not findings.exists()
    assert summary["mode"] == mode and summary["cases"] == 2
    assert summary["device"] == {"name": "cpu"}


def test_wrong_render_is_reported_by_parity(tmp_path, capsys, monkeypatch):
    real = pipeline.render

    def off_by_2e3(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, tuple):
            return out[0] + np.float32(2e-3), out[1]
        return out + np.float32(2e-3)

    monkeypatch.setattr(pipeline, "render", off_by_2e3)
    findings = tmp_path / "findings.jsonl"
    rc, summary = run("parity", 2, findings, capsys)
    assert rc == 1
    assert summary["findings"] == 2
    records = [json.loads(line) for line in findings.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["parity_violation"] * 2
    assert all(r["err"] >= 2e-3 - 1e-6 for r in records)
    assert [r["seed"] for r in records] == [1000, 1001]
