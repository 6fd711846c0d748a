"""The port's tooling utilities on the CPU, beside the JAX package's:

- ``utils/watchdog.StallWatchdog``: the cases of ``tests/test_watchdog.py``
  against the port's copy (firing on frozen progress, progress and real
  I/O resetting the timer, the self-read I/O tax not resetting it, the real
  ``/proc/self/io`` reader on an idle process, ``timeout_s=0``, a raising
  progress probe);
- ``utils/profiling``: ``TimingResult.__str__`` equal to the JAX one for
  the same numbers, ``time_call``, ``trace_span``, ``profiler_session``
  writing a Chrome trace;
- ``utils/logging_config``: idempotent, rooted at ``ars_torch``, apart
  from the JAX package's ``ars_tpu``;
- ``graft_entry.entry()``: ``fn(*args)`` equal to the JAX
  ``__graft_entry__.entry()`` output within 2e-5; ``dryrun_multichip``
  raises, naming ROADMAP item 16.
"""

import itertools
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.utils import logging_config as jax_logging
from audio_raytracing_studio_tpu.utils.profiling import TimingResult as JaxTimingResult
from audio_raytracing_studio_tpu_torch import graft_entry
from audio_raytracing_studio_tpu_torch.utils import logging_config, profiling
from audio_raytracing_studio_tpu_torch.utils import watchdog as wdmod
from audio_raytracing_studio_tpu_torch.utils.watchdog import StallWatchdog

torch.set_num_threads(1)


# ------------------------------------------------------------------ watchdog


@pytest.fixture
def frozen_io(monkeypatch):
    """Pin the process-I/O signal so the tests control progress alone."""
    monkeypatch.setattr(wdmod, "_io_bytes", lambda: 1234)


def test_fires_on_frozen_progress(frozen_io):
    fired = threading.Event()
    msgs = []

    def on_stall(msg):
        msgs.append(msg)
        fired.set()

    wd = StallWatchdog(lambda: ("static",), timeout_s=0.15, poll_s=0.03, on_stall=on_stall)
    with wd:
        assert fired.wait(timeout=5.0), "watchdog never fired on frozen progress"
    assert "no progress" in msgs[0]


def test_progress_resets_the_timer(frozen_io):
    fired = threading.Event()
    counter = itertools.count()
    wd = StallWatchdog(lambda: next(counter), timeout_s=0.15, poll_s=0.03,
                       on_stall=lambda msg: fired.set())
    with wd:
        time.sleep(0.6)  # 4× the stall timeout of steady progress
    assert not fired.is_set()


def test_io_movement_counts_as_progress(monkeypatch):
    fired = threading.Event()
    io = itertools.count(step=1 << 20)  # 1 MiB per poll: a real transfer
    monkeypatch.setattr(wdmod, "_io_bytes", lambda: next(io))
    wd = StallWatchdog(lambda: ("static",), timeout_s=0.15, poll_s=0.03,
                       on_stall=lambda msg: fired.set())
    with wd:
        time.sleep(0.6)
    assert not fired.is_set()


def test_self_read_io_tax_does_not_reset_timer(monkeypatch):
    fired = threading.Event()
    io = itertools.count(step=200)  # about the watchdog's own /proc read
    monkeypatch.setattr(wdmod, "_io_bytes", lambda: next(io))
    wd = StallWatchdog(lambda: ("static",), timeout_s=0.15, poll_s=0.03,
                       on_stall=lambda msg: fired.set())
    with wd:
        assert fired.wait(timeout=5.0), "watchdog is inert: its own read resets the timer"


def test_fires_with_real_io_bytes_on_idle_process():
    fired = threading.Event()
    wd = StallWatchdog(lambda: ("static",), timeout_s=0.3, poll_s=0.05,
                       on_stall=lambda msg: fired.set())
    with wd:
        assert fired.wait(timeout=10.0), "watchdog with the real _io_bytes never fired"


def test_zero_timeout_disables(frozen_io):
    wd = StallWatchdog(lambda: 0, timeout_s=0.0, on_stall=lambda m: None)
    with wd:
        assert wd._thread is None


def test_progress_exception_is_no_change_not_death(frozen_io):
    fired = threading.Event()

    def progress():
        raise RuntimeError("stats race during teardown")

    wd = StallWatchdog(progress, timeout_s=0.15, poll_s=0.03, on_stall=lambda msg: fired.set())
    with wd:
        assert fired.wait(timeout=5.0)


# ----------------------------------------------------------------- profiling


@pytest.mark.parametrize("numbers", [(3, 0.0123456, 0.012, 0.0101),
                                     (1, 1.5, 1.5, 1.5), (50, 2.5e-5, 2.4e-5, 1e-6)])
def test_timing_result_prints_as_the_jax_one(numbers):
    n, per_call, median, fastest = numbers
    ours = profiling.TimingResult("render", n, per_call, median, fastest)
    ref = JaxTimingResult("render", n, per_call, median, fastest)
    assert str(ours) == str(ref)
    assert ours.realtime_factor(60.0) == ref.realtime_factor(60.0)


def test_time_call_counts_its_calls():
    calls = []
    result = profiling.time_call(lambda x: calls.append(x), 7, name="f", iterations=4,
                                 warmup=2, device="cpu")
    assert calls == [7] * 6
    assert result.iterations == 4 and result.name == "f"
    assert 0 <= result.seconds_min <= result.seconds_median
    assert result.seconds_min <= result.seconds_per_call


def test_profiler_session_writes_a_trace_with_the_span(tmp_path):
    with profiling.profiler_session(str(tmp_path)):
        with profiling.trace_span("ars_span"):
            torch.fft.rfft(torch.ones(4096))
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "ars_span" in names


# ------------------------------------------------------------------- logging


def test_configure_is_idempotent_and_rooted_apart(monkeypatch):
    root = logging.getLogger(logging_config.ROOT_LOGGER)
    jax_handlers = list(logging.getLogger(jax_logging.ROOT_LOGGER).handlers)
    saved = list(root.handlers), root.level
    for h in saved[0]:
        root.removeHandler(h)
    try:
        monkeypatch.setenv("ARS_TORCH_LOG_LEVEL", "WARNING")
        first = logging_config.configure()
        second = logging_config.configure("DEBUG")
        assert first is second is root
        assert root.name == "ars_torch" and len(root.handlers) == 1
        assert root.level == logging.WARNING  # the environment's, set once
        assert logging_config.get_logger("serving").name == "ars_torch.serving"
        assert logging_config.get_logger("x").parent is root
        assert jax_logging.ROOT_LOGGER == "ars_tpu"
        assert logging.getLogger(jax_logging.ROOT_LOGGER).handlers == jax_handlers
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])


# --------------------------------------------------------------- graft entry


def test_entry_renders_as_the_jax_entry(record_property):
    import __graft_entry__ as jax_entry

    jfn, jargs = jax_entry.entry()
    ref = np.asarray(jfn(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1,) + ref.shape == (1, 6, 24000 + 72000 - 1)
    err = float(np.abs(out[0].numpy() - ref).max())
    record_property("max_abs_vs_jax", err)
    assert err <= 2e-5


def test_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_multichip_names_item_16():
    """ROADMAP item 16 (multi-device) is in: the dry run takes the visible
    cards by default and refuses, as the JAX one does, when there are fewer
    devices than asked for."""
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(8\) but only 2 devices"):
        graft_entry.dryrun_multichip(8, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.dryrun_multichip(8)


def test_dryrun_multichip_on_eight_cpu_shards():
    report = graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert report["batch"][0] == 16 and report["batch"][2] == 6
    assert report["partitioned"] == [2, 4]
    assert report["long"][1] == 8 and np.isfinite(report["long_metrics"]["lufs"])

