"""The reader of ``render.back_half_kernel_miss_per_batch.batch`` on hand-built
counters: N kernel calls over N ``ars.render_batch`` calls read 0, any other
count reads more (none less), and a program without the kernels (one older
than them) reads None."""

import importlib.util
import types

import pytest

from portbench import program_spans
from portbench import run as bench

METRIC = "render.back_half_kernel_miss_per_batch.batch"
CALLS = 20


def program(monkeypatch, counters):
    table = {"ars.render_batch": {"calls": CALLS, "host_s": 1.0, "host_self_s": 1.0,
                                  "stream_s": None, "stream_self_s": None, "parents": {}}}
    fake = types.SimpleNamespace(span_table=lambda: table, counters=lambda: counters)
    monkeypatch.setattr(program_spans, "_profiling", lambda: fake)


def a_run(device="cuda"):
    return types.SimpleNamespace(device=device, cell=dict(batch=48))


def test_listed_in_every_cell_lower_is_better():
    for cell in ("room-stereo.batch48", "cathedral300-5.1-eq.batch48-padded",
                 "room-stereo.batch48-fast"):
        entry = {m["name"]: m for m in bench.cell_spec(cell)["per_layer"]}[METRIC]
        assert entry["better"] == "lower" and entry["source"] == "program_counter"


@pytest.mark.parametrize("count, want", [(CALLS, 0.0), (0, 1.0), (CALLS // 2, 0.5),
                                         (2 * CALLS, 1.0)])
def test_reads_distance_of_calls_per_render_batch_from_one(monkeypatch, count, want):
    program(monkeypatch, {"ars.back_half_kernels": count})
    assert bench.reader(METRIC)(a_run()) == pytest.approx(want)


def test_plain_path_on_the_card_reads_one(monkeypatch):
    """The program has the kernels, yet no call took them: no counter."""
    program(monkeypatch, {"ars.fft_plans_built": 0})
    assert bench.reader(METRIC)(a_run()) == 1.0


def test_none_on_a_program_without_the_kernels(monkeypatch):
    program(monkeypatch, {"ars.fft_plans_built": 0})
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("back_half_cuda") else real(name, *a))
    assert bench.reader(METRIC)(a_run()) is None


def test_none_off_a_card(monkeypatch):
    program(monkeypatch, {"ars.back_half_kernels": CALLS})
    assert bench.reader(METRIC)(a_run("cpu")) is None
