"""The port's spans inside ``render_batch`` (``utils.profiling.trace_span``
at the call sites of each stage in ``parallel/sharding`` and
``models/pipeline``), on the CPU with tiny clips.

With no profiler on, a render records nothing.  Under a torch profiler one
``render_batch`` call records one call of each stage span its path runs,
each under ``ars.render_batch`` (``ars.eq`` under ``ars.back_half``), and
the outputs and metrics stay bit-identical to a render with spans off.  In
``profiler_session``'s Chrome trace the convolution's FFT ops lie inside the
``ars.conv`` range (one clock).  Threads rendering at once lose no call.
Stream times and the plan counter need a card; their bookkeeping is checked
here with stand-in events and plan counts.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.parallel import mesh as meshlib
from audio_raytracing_studio_tpu_torch.parallel import sharding
from audio_raytracing_studio_tpu_torch.utils import profiling

RATE = 16000
N = RATE // 2
STAGES = ("ars.setup", "ars.upload", "ars.conv", "ars.back_half", "ars.meter",
          "ars.download")
EQ = RenderParams(target_layout="Stereo", room_size=50.0, bass_gain=2.0, treble_gain=0.4)
PLAIN = RenderParams(target_layout="Stereo", room_size=50.0)


def clips(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((batch, N))).astype(np.float32)


def external_ir():
    rng = np.random.default_rng(5)
    return (0.2 * rng.standard_normal((600, 2))).astype(np.float32)


# path → (render_batch kwargs, the spans it runs besides STAGES, shards)
PATHS = {
    "exact": (dict(params=PLAIN), {"ars.air"}, 1),
    "fast": (dict(params=PLAIN, fast_filters=True), set(), 1),
    "eq-static": (dict(params=EQ), {"ars.air", "ars.eq"}, 1),
    "padded-eq": (dict(params=[EQ, EQ, PLAIN], clip_lengths=[N, N - 777, N - 1234]),
                  {"ars.air", "ars.eq"}, 1),
    "external": (dict(params=RenderParams(use_external_ir=True, target_layout="5.1 (Standard)",
                                          dry_wet=0.6, bass_gain=1.6),
                      external_ir=external_ir(), clip_lengths=[N, N - 900, N - 50]),
                 {"ars.eq"}, 1),
    "mesh": (dict(params=PLAIN, fast_filters=True, batch=4,
                  device_mesh=meshlib.make_mesh(devices=["cpu"] * 2)), set(), 2),
}


def render(path, **extra):
    kw = {**PATHS[path][0], "with_metrics": True, "pcm16_output": True, **extra}
    audio = clips(kw.pop("batch", 3))
    return sharding.render_batch(audio, RATE, kw.pop("params"), seeds=range(7, 7 + len(audio)),
                                 device="cpu", **kw)


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_no_profiler_records_nothing():
    assert not profiling.spans_on()
    render("padded-eq")
    assert profiling.span_table() == {}
    assert profiling.counters() == {}


@pytest.mark.parametrize("path", list(PATHS))
def test_one_call_of_each_stage_under_render_batch(path):
    with torch.profiler.profile():
        assert profiling.spans_on()
        render(path)
    table = profiling.span_table()
    _, more, shards = PATHS[path]
    assert set(table) == {"ars.render_batch", *STAGES, *more}
    assert table["ars.render_batch"]["calls"] == 1
    assert table["ars.render_batch"]["parents"] == {None: 1}
    assert table["ars.setup"]["calls"] == 1
    for name in set(table) - {"ars.render_batch", "ars.setup"}:
        assert table[name]["calls"] == shards, name
    for name in set(table) - {"ars.render_batch"}:
        parent = "ars.back_half" if name == "ars.eq" else "ars.render_batch"
        assert table[name]["parents"] == {parent: table[name]["calls"]}, name
    for name, row in table.items():
        assert 0 <= row["host_self_s"] <= row["host_s"], name
        assert row["stream_s"] is None and row["stream_self_s"] is None, name  # the CPU
    children = sum(table[n]["host_s"] for n in table if n not in ("ars.render_batch", "ars.eq"))
    top = table["ars.render_batch"]
    assert top["host_self_s"] == pytest.approx(top["host_s"] - children, abs=1e-6)
    assert profiling.counters() == {}  # no cuFFT plan cache off a card


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_leave_outputs_bit_identical(path):
    off_pcm, off_metrics = render(path)
    with torch.profiler.profile():
        on_pcm, on_metrics = render(path)
    assert on_pcm.dtype == np.int16
    np.testing.assert_array_equal(on_pcm, off_pcm)
    assert on_metrics == off_metrics


def test_single_clip_render_opens_stage_spans_without_a_batch():
    from audio_raytracing_studio_tpu_torch.models import pipeline

    with torch.profiler.profile():
        pipeline.render(clips(1)[0], RATE, EQ, seed=3, device="cpu")
    table = profiling.span_table()
    assert set(table) == {"ars.conv", "ars.air", "ars.back_half", "ars.eq"}
    assert table["ars.conv"]["parents"] == {None: 1}
    assert table["ars.eq"]["parents"] == {"ars.back_half": 1}


def test_chrome_trace_puts_the_convs_ffts_inside_ars_conv(tmp_path):
    with profiling.profiler_session(str(tmp_path)):
        # no air, no EQ, no meter (its K-weighting runs FFTs too): every FFT
        # of the render is the conv's
        render("fast", with_metrics=False)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    conv = [e for e in events if e.get("name") == "ars.conv" and e.get("ph") == "X"]
    assert len(conv) == 1 and conv[0].get("cat") == "user_annotation"
    t0, t1 = conv[0]["ts"], conv[0]["ts"] + conv[0]["dur"]
    ffts = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("aten::")
            and "fft" in e["name"]]
    assert ffts
    for e in ffts:
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1, e["name"]


def test_threads_rendering_at_once_lose_no_calls():
    calls, errors = 3, []

    def worker():
        try:
            for _ in range(calls):
                render("fast")
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with torch.profiler.profile():
            threads = [threading.Thread(target=worker) for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    table = profiling.span_table()
    for name in ("ars.render_batch", *STAGES):
        assert table[name]["calls"] == 3 * calls, name
    for name in STAGES:  # each thread's own stack of open spans
        assert table[name]["parents"] == {"ars.render_batch": 3 * calls}, name


def test_plan_counter_adds_the_caches_growth_per_call(monkeypatch):
    plans = iter([10, 12, 12, 12])
    monkeypatch.setattr(sharding, "_fft_plans", lambda dev, mesh: next(plans))
    render("fast")  # spans off: the caches are not read
    assert profiling.counters() == {}
    with torch.profiler.profile():
        render("fast")
        render("fast")
    assert profiling.counters() == {"ars.fft_plans_built": 2}
    assert profiling.span_table()["ars.render_batch"]["calls"] == 2


class FakeEvent:
    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


class FakeStream:
    def __init__(self, name):
        self.name, self.device_index = name, 0

    def __eq__(self, other):
        return isinstance(other, FakeStream) and other.name == self.name


class FakeSpan:
    def __init__(self, name, parent, stream, start, end):
        self.name, self.parent, self.stream = name, parent, stream
        self.start, self.end, self.child_ns = start, end, 0


def test_stream_self_time_leaves_out_children_on_the_same_stream_only():
    rec = profiling._Recorder()
    s0, s1 = FakeStream("s0"), FakeStream("s1")
    top = FakeSpan("top", None, s0, FakeEvent(0.0), FakeEvent(10.0, done=False))
    same = FakeSpan("same", top, s0, FakeEvent(1.0), FakeEvent(4.0))
    other = FakeSpan("other", top, s1, FakeEvent(0.0), FakeEvent(2.0))
    top.child_ns = 3_000
    for span, host_ns in ((same, 1_000), (other, 2_000), (top, 5_000)):
        rec.close(span, host_ns)
    rec.fold(wait=False)  # the oldest pairs are done, the top's is not
    assert len(rec._pending) == 1 and rec._rows["top"]["stream_s"] is None
    table = rec.table()  # waits for the rest
    assert not rec._pending
    assert table["top"]["stream_s"] == pytest.approx(0.010)
    assert table["top"]["stream_self_s"] == pytest.approx(0.007)  # less "same" only
    assert table["same"]["stream_self_s"] == pytest.approx(0.003)
    assert table["other"]["stream_s"] == pytest.approx(0.002)
    assert table["top"]["host_s"] == pytest.approx(5e-6)
    assert table["top"]["host_self_s"] == pytest.approx(2e-6)
    assert table["same"]["parents"] == {"top": 1} and table["top"]["parents"] == {None: 1}
    # the folded events go back to a pool and are recorded again
    assert len(rec._free[0]) == 6 and rec.event(s0) in (same.start, same.end, other.start,
                                                          other.end, top.start, top.end)


def test_counters_and_reset():
    profiling.counter_add("c", 2)
    profiling.counter_add("c", 3)
    assert profiling.counters() == {"c": 5}
    with torch.profiler.profile():
        with profiling.trace_span("x", "cpu"):
            pass
    assert profiling.span_table()["x"]["calls"] == 1
    profiling.reset_spans()
    assert profiling.counters() == {} and profiling.span_table() == {}


def test_a_span_off_is_one_shared_null_context():
    assert profiling.trace_span("a") is profiling.trace_span("b", "cpu")
