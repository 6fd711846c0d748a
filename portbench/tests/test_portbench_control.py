"""The comparison that decides ``correct`` must reject the lower-precision
control and each fault the timed path can have."""

import numpy as np
import pytest

from portbench import run as bench
from portbench.reference import control
from portbench.tests.conftest import TINY
from portbench.tests.test_portbench_cells import CELLS


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, restore_render_batch):
    restore_render_batch.render_batch = control.render_batch
    line = bench.run_cell(workload, 11, 0.3, False, "cpu", TINY)
    assert line["correct"] is False
    assert line["check"]["pcm_gap_lsb"]["value"] > line["check"]["pcm_gap_lsb"]["limit"]


def _broken(original, kind):
    """``render_batch`` with the timed path broken underneath."""

    def render_batch(audio, rate, params, **kw):
        fetch = original(audio, rate, params, **{**kw, "async_results": True})

        def broken():
            if kind == "error":  # the answer never comes
                raise RuntimeError("the copy down failed")
            got = fetch()
            out = got[0] if isinstance(got, tuple) else got
            if kind == "unchanged":  # the step hands its input back
                n = min(out.shape[1], audio.shape[1])
                out[:] = 0
                out[:, :n] = np.round(np.asarray(audio)[:out.shape[0], :n, :1] * 32767)
            elif kind == "half":  # half of the batch left out
                out[out.shape[0] // 2:] = 0
            elif kind == "altered":  # one answer altered where it is produced
                mid = out.shape[1] // 2
                out[:, mid] = np.where(out[:, mid] > 0, out[:, mid] - 1000, out[:, mid] + 1000)
            return got

        return broken if kw.get("async_results") else broken()

    return render_batch


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails_batch_cells(workload, kind, restore_render_batch):
    sharding = restore_render_batch
    sharding.render_batch = _broken(sharding.render_batch, kind)
    line = bench.run_cell(workload, 12, 1.0, False, "cpu", TINY)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("workload", CELLS)
def test_answer_that_never_comes_gives_no_result(workload, restore_render_batch):
    sharding = restore_render_batch
    sharding.render_batch = _broken(sharding.render_batch, "error")
    with pytest.raises(RuntimeError, match="the copy down failed"):
        bench.run_cell(workload, 13, 1.0, False, "cpu", TINY)
