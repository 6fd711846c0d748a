"""The readers of the program's own spans and counters
(``portbench/program_spans.py`` and the metrics that use it), each on a
hand-built span table: the per-clip and per-call arithmetic, the back
half's self time, and None where a span or counter is missing, the device
is the CPU, or the program records no spans at all (an older program)."""

import types

import pytest

from portbench import program_spans
from portbench import run as bench

BATCH = 48
CALLS = 20


def row(calls=CALLS, host_s=0.0, host_self_s=None, stream_s=None, stream_self_s=None,
        parent="ars.render_batch"):
    return {"calls": calls, "host_s": host_s,
            "host_self_s": host_s if host_self_s is None else host_self_s,
            "stream_s": stream_s,
            "stream_self_s": stream_s if stream_self_s is None else stream_self_s,
            "parents": {parent: calls}}


# per call: render_batch 160 ms host (30 of them set-up), 240 ms of stream;
# each stage's stream time over 20 calls
TABLE = {
    "ars.render_batch": row(host_s=CALLS * 0.160, host_self_s=CALLS * 0.020,
                            stream_s=CALLS * 0.240, stream_self_s=CALLS * 0.012,
                            parent=None),
    "ars.setup": row(host_s=CALLS * 0.030),
    "ars.upload": row(stream_s=CALLS * 0.024),
    "ars.conv": row(stream_s=CALLS * 0.048),
    "ars.air": row(stream_s=CALLS * 0.036),
    "ars.back_half": row(stream_s=CALLS * 0.096, stream_self_s=CALLS * 0.024),
    "ars.eq": row(stream_s=CALLS * 0.072, parent="ars.back_half"),
    "ars.meter": row(stream_s=CALLS * 0.012),
    "ars.download": row(stream_s=CALLS * 0.012),
}
COUNTERS = {"ars.fft_plans_built": 0}

# metric → what it reads from TABLE / COUNTERS
EXPECTED = {
    "entry.setup_host_ms_per_batch.batch": 30.0,
    "entry.enqueue_host_ms_per_batch.batch": 130.0,
    "entry.upload_stream_ms_per_clip.batch": 24.0 / BATCH,
    "render.conv_stream_ms_per_clip.batch": 48.0 / BATCH,
    "render.air_stream_ms_per_clip.batch": 36.0 / BATCH,
    "render.eq_stream_ms_per_clip.batch": 72.0 / BATCH,
    "render.back_half_stream_ms_per_clip.batch": 24.0 / BATCH,  # self: 96 less the EQ's 72
    "render.meter_stream_ms_per_clip.batch": 12.0 / BATCH,
    "entry.download_stream_ms_per_clip.batch": 12.0 / BATCH,
    "render.fft_plans_built_per_batch.batch": 0.0,
}
STREAM = [m for m in EXPECTED if "_stream_" in m]
SPAN_OF = {
    "entry.setup_host_ms_per_batch.batch": "ars.setup",
    "entry.enqueue_host_ms_per_batch.batch": "ars.render_batch",
    "entry.upload_stream_ms_per_clip.batch": "ars.upload",
    "render.conv_stream_ms_per_clip.batch": "ars.conv",
    "render.air_stream_ms_per_clip.batch": "ars.air",
    "render.eq_stream_ms_per_clip.batch": "ars.eq",
    "render.back_half_stream_ms_per_clip.batch": "ars.back_half",
    "render.meter_stream_ms_per_clip.batch": "ars.meter",
    "entry.download_stream_ms_per_clip.batch": "ars.download",
    "render.fft_plans_built_per_batch.batch": "ars.render_batch",
}


def a_run(device="cuda"):
    return types.SimpleNamespace(device=device, cell=dict(batch=BATCH))


@pytest.fixture
def program(monkeypatch):
    """The program's recorder replaced by the tables each test sets."""
    state = {"table": dict(TABLE), "counters": dict(COUNTERS)}
    fake = types.SimpleNamespace(span_table=lambda: state["table"],
                                 counters=lambda: state["counters"])
    monkeypatch.setattr(program_spans, "_profiling", lambda: fake)
    return state


def test_every_new_metric_is_listed_and_reads_its_span():
    spec = bench.cell_spec("cathedral300-5.1-eq.batch48-padded")
    assert set(EXPECTED) <= {m["name"] for m in spec["per_layer"]}


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_arithmetic(program, metric):
    assert bench.reader(metric)(a_run()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_none_without_its_span(program, metric):
    del program["table"][SPAN_OF[metric]]
    assert bench.reader(metric)(a_run()) is None


@pytest.mark.parametrize("metric", STREAM)
def test_stream_reader_none_on_the_cpu(program, metric):
    assert bench.reader(metric)(a_run("cpu")) is None


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_none_for_a_program_without_spans(monkeypatch, metric):
    monkeypatch.setattr(program_spans, "_profiling", lambda: types.SimpleNamespace())
    assert bench.reader(metric)(a_run()) is None


def test_enqueue_needs_the_setup_span(program):
    del program["table"]["ars.setup"]
    assert bench.reader("entry.enqueue_host_ms_per_batch.batch")(a_run()) is None


def test_plan_counter_per_call(program):
    program["counters"]["ars.fft_plans_built"] = 5
    reader = bench.reader("render.fft_plans_built_per_batch.batch")
    assert reader(a_run()) == pytest.approx(5 / CALLS)
    assert reader(a_run("cpu")) == pytest.approx(5 / CALLS)  # a count, not a device time
    del program["counters"]["ars.fft_plans_built"]
    assert reader(a_run()) is None


def test_stream_reader_none_where_the_span_recorded_no_events(program):
    program["table"]["ars.conv"] = row()  # host only: stream_s None
    assert bench.reader("render.conv_stream_ms_per_clip.batch")(a_run()) is None
