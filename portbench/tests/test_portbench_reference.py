"""A configuration names its own plain reference: the harness resolves it
from the configuration, passes the extra inputs that the reference makes
for each batch to the program's ``render_batch`` and to the reference's
``render_row`` unchanged, and its control follows it.

The external-IR configuration here is defined with a reference module that
the test puts into ``sys.modules`` and no file of the harness edited."""

import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench import run as bench
from portbench.control import use_control
from portbench.reference import render as ref
from portbench.tests.conftest import TINY
from portbench.tests.test_portbench_cells import CELLS

STUB = "ext_ir_stub"
IR_RATE = 44100
IR_SECONDS = 0.2


# --- a plain external-IR reference, for the test alone -----------------------
def _batch_inputs(run, k, rng):
    """One stereo IR a batch, 0.2 s at 44.1 kHz from the seed: decaying noise."""
    n = int(IR_SECONDS * IR_RATE)
    decay = np.exp(-np.arange(n) / (0.05 * IR_RATE))
    ir = (rng.standard_normal((n, 2)) * decay[:, None] * 0.5).astype(np.float32)
    return {"external_ir": ir, "external_ir_rate": IR_RATE}


def _resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """Fourier resampling of the last axis (scipy.signal.resample's rule)."""
    n = x.shape[-1]
    m = min(num, n)
    spec = torch.fft.rfft(x, n=n)[..., : m // 2 + 1]
    if m % 2 == 0:
        spec[..., m // 2] *= 2.0 if num < n else 0.5
    return torch.fft.irfft(spec, n=num) * (num / n)


def _render_row(clip, rate, params, seed, clip_length=None, fast=False, padded_eq=False,
                prec=ref.FLOAT64, device="cpu", external_ir=None, external_ir_rate=None):
    """L⊛IR_L, R⊛IR_R, dry/wet with dry-kill, shelf EQ, normalizations, pan
    and map, each stage stored in ``prec``."""
    _render_row.seen.append((external_ir, prec))
    assert clip_length is None and not padded_eq  # the test's traffic pads no clip
    g = ref.derive(params, rate)
    a = torch.as_tensor(np.asarray(clip, np.float32)).to(device=device, dtype=prec.dtype)
    a = a[:, None] if a.dim() == 1 else a
    a = prec.q((a.expand(-1, 2) if a.shape[1] == 1 else a[:, :2]).T.contiguous())
    ir = torch.as_tensor(np.asarray(external_ir, np.float32)).to(device, prec.dtype).T
    if external_ir_rate != rate:
        ir = _resample(ir, int(ir.shape[-1] * rate / external_ir_rate))
    ir = prec.q(ir)
    n, len_out = a.shape[-1], a.shape[-1] + ir.shape[-1] - 1
    nfft = ref.fast_fft_length(len_out)
    wet = prec.q(torch.fft.irfft(torch.fft.rfft(a, n=nfft) * torch.fft.rfft(ir, n=nfft),
                                 n=nfft)[:, :len_out])
    dry = torch.nn.functional.pad(a, (0, len_out - n))
    mixed = prec.q(g["dry_factor"] * (1.0 - g["dry_wet"]) * dry + g["dry_wet"] * wet)
    if g["eq_on"]:
        mixed = ref.circular(mixed, ref.shelf_gain(len_out, rate, g["bass"], g["treble"],
                                                   device), prec)
    mixed = prec.q(ref.normalize(mixed))
    six = prec.q(ref.normalize(prec.q(ref.pan(mixed, g))))
    return prec.q(ref.normalize(prec.q(ref.layout(six, g, rate)))), len_out


@pytest.fixture
def external_ir_cell(monkeypatch):
    """``room-stereo.batch48``'s traffic and limits under an external-IR
    configuration (stereo in, dry/wet 0.7 with the dry partly killed, EQ on)
    whose ``"reference"`` names the stub → (workload, stub module, the
    inputs ``batch_inputs`` made, with a copy of each)."""
    made = []

    def batch_inputs(run, k, rng):
        extra = _batch_inputs(run, k, rng)
        made.append((extra, extra["external_ir"].copy()))
        return extra

    stub = types.ModuleType(f"portbench.reference.{STUB}")
    stub.render_row, stub.batch_inputs = _render_row, batch_inputs
    _render_row.seen = []
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    workload = "room-stereo.batch48"
    spec = bench.cell_spec(workload)
    config = dict(spec["config"], name="external-ir", reference=STUB, input_channels=2,
                  params=dict(spec["config"]["params"], use_external_ir=True, dry_wet=0.7,
                              bass_gain=1.6, treble_gain=0.7))
    monkeypatch.setattr(bench, "cell_spec", lambda name: dict(spec, config=config))
    return workload, stub, made


def _recorder(monkeypatch, owner, name):
    """Wrap ``owner.name``, recording each call's (args, kwargs)."""
    original, calls = getattr(owner, name), []

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    monkeypatch.setattr(owner, name, wrapped)
    return calls


@pytest.mark.parametrize("workload", CELLS)
def test_cells_resolve_to_the_internal_hall(workload, monkeypatch):
    """No ``"reference"`` key: ``render.render_row`` with the arguments it has
    always had, and no more."""
    spec = bench.cell_spec(workload)
    assert "reference" not in spec["config"]
    assert harness.reference(spec["config"]) is ref
    calls = _recorder(monkeypatch, ref, "render_row")
    line = bench.run_cell(workload, 11, 0.3, False, "cpu", TINY)
    assert line["correct"] is True, line["check"]
    assert calls
    padded = bool(spec["traffic"].get("true_length_share"))
    for args, kwargs in calls:
        clip, rate, params, seed, clip_length, fast, padded_eq, prec, device = args
        assert kwargs == {}
        assert isinstance(clip, np.ndarray) and rate == spec["config"]["rate"]
        assert params == spec["config"]["params"] and isinstance(seed, int)
        assert (clip_length is not None) == padded and padded_eq is padded
        assert fast is bool(spec["traffic"]["fast_filters"])
        assert prec is ref.FLOAT64 and device == torch.device("cpu")


def test_named_reference_gets_its_batch_inputs(external_ir_cell, restore_render_batch,
                                              monkeypatch):
    """The stub's ``batch_inputs`` reach ``render_batch`` and ``render_row`` as
    the same objects, unaltered, and the port's external-IR path agrees with
    the stub's float64 render."""
    workload, stub, made = external_ir_cell
    calls = _recorder(monkeypatch, restore_render_batch, "render_batch")
    line = bench.run_cell(workload, 21, 0.3, False, "cpu", TINY)
    assert line["correct"] is True, line["check"]
    assert len(made) == TINY["distinct_batches"]
    ids = {id(extra["external_ir"]) for extra, _ in made}
    for _, kwargs in calls:
        assert id(kwargs["external_ir"]) in ids and kwargs["external_ir_rate"] == IR_RATE
    assert stub.render_row.seen
    assert {id(ir) for ir, _ in stub.render_row.seen} <= ids
    for extra, copy in made:
        np.testing.assert_array_equal(extra["external_ir"], copy)


def test_altered_inputs_fail(external_ir_cell, monkeypatch):
    """A sample whose IR is scaled by 0.5 before the check is not correct:
    the check reads the inputs the sample carries."""
    workload, _, _ = external_ir_cell
    original = harness.check

    def check(run, limits, *args):
        s = run.samples[0]
        s.inputs = dict(s.inputs, external_ir=s.inputs["external_ir"] * 0.5)
        return original(run, limits, *args)

    monkeypatch.setattr(harness, "check", check)
    line = bench.run_cell(workload, 22, 0.3, False, "cpu", TINY)
    assert line["correct"] is False, line["check"]


def test_control_follows_the_named_reference(external_ir_cell, restore_render_batch,
                                             monkeypatch):
    """``--control``'s swap renders with the stub's ``render_row`` in bfloat16,
    with the batch's IR, and the check rejects it."""
    workload, stub, made = external_ir_cell
    gen = bench.generator(bench.cell_spec(workload)["traffic"])
    monkeypatch.setattr(gen, "WARM_ROUNDS", gen.WARM_ROUNDS)
    use_control(bench.cell_spec(workload))
    line = bench.run_cell(workload, 23, 0.3, False, "cpu", TINY)
    assert line["correct"] is False
    assert line["check"]["pcm_gap_lsb"]["value"] > line["check"]["pcm_gap_lsb"]["limit"]
    # the control's rows (bfloat16) and the check's (float64) both went
    # through the stub, with the batch's IR
    ids = {id(extra["external_ir"]) for extra, _ in made}
    assert {id(ir) for ir, _ in stub.render_row.seen} <= ids
    assert {prec for _, prec in stub.render_row.seen} == {ref.BF16, ref.FLOAT64}
