"""The port's copies of the float64 NumPy / SciPy oracle (oracle/dsp.py,
oracle/loudness.py) against the JAX package's, on the same inputs.

Tolerance: none.  The copies hold the same code over the port's own copies of
``config``, ``params`` and ``metering.kweighting``; every output must be
**equal**, element for element (each test records the gap, which must be 0).
Also ``analysis.metrics.calculate_audio_metrics(backend="oracle")`` and the
analyzer CLI's ``--backend oracle``, which route to the copy.
"""

import json

import numpy as np
import pytest

from audio_raytracing_studio_tpu import params as jparams
from audio_raytracing_studio_tpu.analysis import metrics as jmetrics
from audio_raytracing_studio_tpu.cli import analyzer as jcli
from audio_raytracing_studio_tpu.oracle import dsp as jdsp
from audio_raytracing_studio_tpu.oracle import loudness as jloud
from audio_raytracing_studio_tpu_torch import params as tparams
from audio_raytracing_studio_tpu_torch.analysis import metrics as tmetrics
from audio_raytracing_studio_tpu_torch.cli import analyzer as tcli
from audio_raytracing_studio_tpu_torch.oracle import dsp as tdsp
from audio_raytracing_studio_tpu_torch.oracle import loudness as tloud
from audio_raytracing_studio_tpu_torch.utils import wavio

RATE = 16000


def signal(n, channels, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.4 * np.sin(2 * np.pi * 0.011 * t)[:, None] + 0.2 * r.standard_normal((n, channels))
    return x.astype(np.float32)


def same(record_property, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    gap = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) if got.size else 0.0
    record_property("max_abs", gap)
    assert np.array_equal(got, want)


def geometry(mod, hall="Room", room_size=120.0, z=0.4):
    dur, count, max_delay, split = mod.adjust_parameters_for_3d(hall, room_size, z)
    direct = mod.compute_final_directionality_3d(0.3, 0.6, z, hall, 0.5, 0.5)
    return mod.derive_ir_geometry(RATE, dur, count, max_delay, "Beton", direct, split, 0.5)


@pytest.mark.parametrize("hall, room_size", [("Room", 120.0), ("Plate", 40.0),
                                             ("Cathedral", 300.0)])
def test_generate_impulse_response_split_equal(record_property, hall, room_size):
    gj, gt = geometry(jparams, hall, room_size), geometry(tparams, hall, room_size)
    dj = jparams.IRDraws.sample(np.random.default_rng(5), gj)
    dt = tparams.IRDraws.sample(np.random.default_rng(5), gt)
    want = jdsp.generate_impulse_response_split(gj, dj)
    got = tdsp.generate_impulse_response_split(gt, dt)
    same(record_property, np.stack(got), np.stack(want))


@pytest.mark.parametrize("factor", [0.0, 0.3, 1.0])
def test_air_absorption_and_shelf_eq_equal(record_property, factor):
    x = signal(4001, 2, 1)
    same(record_property, tdsp.apply_air_absorption(x, RATE, factor),
         jdsp.apply_air_absorption(x, RATE, factor))
    same(record_property, tdsp.apply_shelf_eq(x, RATE, 1.0 + factor, 0.6),
         jdsp.apply_shelf_eq(x, RATE, 1.0 + factor, 0.6))


@pytest.mark.parametrize("dry_wet, kill", [(0.0, 0.5), (0.5, 0.5), (0.8, 0.5), (1.0, 0.2)])
@pytest.mark.parametrize("n_wet", [3000, 4000, 5000])
def test_dynamic_dry_wet_mix_equal(record_property, dry_wet, kill, n_wet):
    dry, wet = signal(4000, 2, 2), signal(n_wet, 2, 3)
    same(record_property, tdsp.dynamic_dry_wet_mix(dry, wet, dry_wet, kill),
         jdsp.dynamic_dry_wet_mix(dry, wet, dry_wet, kill))


@pytest.mark.parametrize("bass, treble, air", [(1.0, 1.0, 0.0), (1.6, 0.7, 0.3)])
def test_convolve_functions_equal(record_property, bass, treble, air):
    x = signal(4000, 2, 4)
    g = geometry(tparams)
    early, late = tdsp.generate_impulse_response_split(
        g, tparams.IRDraws.sample(np.random.default_rng(6), g))
    same(record_property,
         tdsp.convolve_audio_split(x, early, late, 0.8, 0.6, 0.5, bass, treble, RATE, 0.5, air),
         jdsp.convolve_audio_split(x, early, late, 0.8, 0.6, 0.5, bass, treble, RATE, 0.5, air))
    ir = signal(900, 2, 7) * np.exp(-np.arange(900) / 200.0)[:, None].astype(np.float32)
    same(record_property,
         tdsp.convolve_audio_external_ir(x, ir, 0.7, bass, treble, RATE, 0.5),
         jdsp.convolve_audio_external_ir(x, ir, 0.7, bass, treble, RATE, 0.5))


@pytest.mark.parametrize("pos", [(0.5, 0.5, 0.5), (0.1, 0.9, 0.2), (1.0, 0.0, 1.0)])
def test_panning_delay_and_mapping_equal(record_property, pos):
    x = signal(3000, 2, 8) * 1.4
    six_t = tdsp.apply_surround_panning(x, *pos)
    same(record_property, six_t, jdsp.apply_surround_panning(x, *pos))
    assert tdsp.surround_panning_gains(*pos) == jdsp.surround_panning_gains(*pos)
    same(record_property, tdsp.apply_delay(x, 37), jdsp.apply_delay(x, 37))
    for layout in ("Stereo", "5.1 (Standard)", "7.1 (Surround)", "5.1.2 (Atmos Light)", "?"):
        got, names_t = tdsp.map_channels(six_t, layout, RATE, pos[2])
        want, names_j = jdsp.map_channels(six_t, layout, RATE, pos[2])
        assert names_t == names_j
        same(record_property, got, want)


@pytest.mark.parametrize("kwargs", [
    dict(target_layout="Stereo"),
    dict(hall_type="Cathedral", room_size=300.0, target_layout="5.1 (Standard)",
         bass_gain=1.6, treble_gain=0.7),
    dict(hall_type="Plate", target_layout="7.1 (Surround)", air_absorption=0.4, z_pos=0.9),
    dict(use_external_ir=True, target_layout="5.1.2 (Atmos Light)"),
])
def test_render_equal(record_property, kwargs):
    x = signal(4000, 1, 9)[:, 0]
    ir = signal(700, 2, 10) * 0.2
    got = tdsp.render(x, RATE, tparams.RenderParams(**kwargs),
                      rng=np.random.default_rng(11), external_ir=ir)
    want = jdsp.render(x, RATE, jparams.RenderParams(**kwargs),
                       rng=np.random.default_rng(11), external_ir=ir)
    same(record_property, got, want)
    same(record_property, tdsp.quantize_pcm16(got), jdsp.quantize_pcm16(want))


@pytest.mark.parametrize("channels, rate", [(1, 16000), (2, 48000), (6, 44100)])
def test_loudness_equal(record_property, channels, rate):
    x = signal(rate, channels, 12)
    same(record_property, tloud.k_weight(x, rate), jloud.k_weight(x, rate))
    assert tloud.integrated_loudness(x, rate) == jloud.integrated_loudness(x, rate)
    assert tloud.calculate_audio_metrics(x, rate) == jloud.calculate_audio_metrics(x, rate)


@pytest.mark.parametrize("x", [np.zeros((0, 2), np.float32), np.zeros((8000, 2), np.float32),
                               signal(3000, 2, 13)], ids=["empty", "silent", "short"])
def test_loudness_edge_inputs_equal(x):
    assert tloud.calculate_audio_metrics(x, RATE) == jloud.calculate_audio_metrics(x, RATE)
    assert tloud.integrated_loudness(x, RATE) == jloud.integrated_loudness(x, RATE)


def test_metrics_backend_oracle_routes_to_the_copy_and_needs_no_device():
    x = signal(RATE, 2, 14)
    got = tmetrics.calculate_audio_metrics(x, RATE, backend="oracle")  # default device unused
    assert got == jmetrics.calculate_audio_metrics(x, RATE, backend="oracle")
    assert got == tloud.calculate_audio_metrics(x, RATE)
    with pytest.raises(ValueError, match="backend"):
        tmetrics.calculate_audio_metrics(x, RATE, device="cpu", backend="jax")


@pytest.mark.parametrize("cmd", ["analyze", "normalize"])
def test_analyzer_cli_backend_oracle_equals_jax(tmp_path, capsys, cmd):
    wavio.write(tmp_path / "in.wav", signal(RATE, 2, 15), RATE)
    argv = [cmd, str(tmp_path / "in.wav")]
    outs = []
    for main, name in ((tcli.main, "t.wav"), (jcli.main, "j.wav")):
        extra = [str(tmp_path / name)] if cmd == "normalize" else []
        capsys.readouterr()
        assert main(argv + extra + ["--backend", "oracle"]) == 0
        out = json.loads(capsys.readouterr().out)
        out.pop("output", None)
        outs.append(out)
    assert outs[0] == outs[1]
    if cmd == "normalize":
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
