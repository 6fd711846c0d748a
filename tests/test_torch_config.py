"""The port's own copies of the host-side modules — ``config``, ``params``
and ``metering.kweighting`` — against the JAX package's, on the CPU.

The port imports nothing of the JAX package, so it carries these three
modules itself; these tests hold each copy equal to its original: the same
constants, and bit-equal float64 results of the parameter math and the
K-weighting design on the same inputs.  ``models.convert`` carries a
``RenderParams`` or ``IRDraws`` of the JAX package across to the port's.
"""

import dataclasses

import numpy as np
import pytest

from audio_raytracing_studio_tpu import config as jconfig
from audio_raytracing_studio_tpu import params as jparams
from audio_raytracing_studio_tpu.metering import kweighting as jkw
from audio_raytracing_studio_tpu_torch import config as tconfig
from audio_raytracing_studio_tpu_torch import params as tparams
from audio_raytracing_studio_tpu_torch.metering import kweighting as tkw
from audio_raytracing_studio_tpu_torch.models import convert

CONSTANTS = sorted(n for n in dir(jconfig) if n.isupper())
KW_CONSTANTS = sorted(n for n in dir(jkw) if n.isupper())
RATES = [8000, 16000, 44100, 48000]
ROOM_SIZES = [5.0, 50.0, 100.0, 300.0, 600.0, 2000.0]


def plain(value):
    """A config value with its dataclasses as (class name, fields), so the
    two packages' instances of same-named classes compare by content."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, plain(dataclasses.asdict(value)))
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    return value


def test_config_lists_the_same_names():
    assert CONSTANTS == sorted(n for n in dir(tconfig) if n.isupper())
    assert KW_CONSTANTS == sorted(n for n in dir(tkw) if n.isupper())
    for module in (tconfig, tparams, tkw):
        assert "audio_raytracing_studio_tpu." not in repr(vars(module).values())


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constant_equal(name):
    want, got = getattr(jconfig, name), getattr(tconfig, name)
    assert type(got) is type(want)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("name", KW_CONSTANTS)
def test_kweighting_constant_equal(name):
    assert getattr(tkw, name) == getattr(jkw, name)


def geometry(m, hall, room, rate, z=0.5, x=0.5, y=0.5, diffusion=0.5, material=None):
    dur, refs, maxd, split = m.adjust_parameters_for_3d(hall, room, z)
    direc = m.compute_final_directionality_3d(x, y, z, hall, diffusion, 0.6)
    material = material or m.config.DEFAULT_MATERIAL
    return m.derive_ir_geometry(rate, dur, refs, maxd, material, direc, split, diffusion)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("hall", sorted(jconfig.HALL_PRESETS))
def test_derive_ir_geometry_equal(hall, rate):
    for room in ROOM_SIZES:
        for z, diffusion, material in ((0.5, 0.5, None), (0.9, 0.0, "Holz"),
                                       (0.1, 1.0, sorted(jconfig.MATERIAL_ABSORPTION)[-1])):
            want = geometry(jparams, hall, room, rate, z=z, diffusion=diffusion,
                            material=material)
            got = geometry(tparams, hall, room, rate, z=z, diffusion=diffusion,
                           material=material)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (room, z, material)
            assert got.early_taps_active == want.early_taps_active


@pytest.mark.parametrize("hall", sorted(jconfig.HALL_PRESETS))
def test_hall_adjustments_and_levels_equal(hall):
    for room in ROOM_SIZES + [-5.0, 0.0]:
        for z in (0.0, 0.3, 0.7, 1.0):
            assert (tparams.adjust_parameters_for_3d(hall, room, z)
                    == jparams.adjust_parameters_for_3d(hall, room, z))
    assert plain(tparams.hall_base_parameters(hall)) == plain(jparams.hall_base_parameters(hall))
    for x, y, z, diffusion, dw in ((0.5, 0.5, 0.5, 0.5, 0.5), (0.0, 1.0, 0.2, 0.9, 0.95),
                                   (1.2, -0.1, 0.8, 0.0, 0.1)):
        assert (tparams.compute_final_directionality_3d(x, y, z, hall, diffusion, dw)
                == jparams.compute_final_directionality_3d(x, y, z, hall, diffusion, dw))


def test_mix_rules_equal():
    for dw in (0.0, 0.2, 0.5, 0.79, 0.8, 0.95, 1.0):
        for kill in (0.0, 0.4, 0.8, 1.0):
            assert tparams.dry_kill_factor(dw, kill) == jparams.dry_kill_factor(dw, kill)
        for early, late in ((1.0, 1.0), (0.0, 2.0), (1.7, 0.3)):
            assert (tparams.adapt_early_late_levels(dw, early, late)
                    == jparams.adapt_early_late_levels(dw, early, late))
    for bass, treble in ((1.0, 1.0), (1.0 + 1e-9, 1.0), (1.6, 1.0), (1.0, 0.7), (0.0, 3.0)):
        assert tparams.eq_enabled(bass, treble) == jparams.eq_enabled(bass, treble)


@pytest.mark.parametrize("hall", ["Room", "Cathedral", "Plate"])
def test_irdraws_sample_equal(hall):
    g = geometry(tparams, hall, 100.0, 16000)
    jg = geometry(jparams, hall, 100.0, 16000)
    got = tparams.IRDraws.sample(np.random.default_rng(7), g)
    want = jparams.IRDraws.sample(np.random.default_rng(7), jg)
    for field in ("delays", "strengths", "noise"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", RATES)
def test_kweighting_design_equal(rate):
    for (tb, ta), (jb, ja) in zip(tkw.k_weighting_coefficients(rate),
                                  jkw.k_weighting_coefficients(rate)):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ta, ja)
    for n in (0, 1, int(0.4 * rate) - 1, int(0.4 * rate), rate, 60 * rate + 123):
        assert tkw.block_count(n, rate) == jkw.block_count(n, rate)


def test_channel_weights_equal():
    for channels in range(1, 10):
        np.testing.assert_array_equal(tkw.channel_weights(channels),
                                      jkw.channel_weights(channels))


def test_convert_carries_params_and_draws_across():
    p = jparams.RenderParams(hall_type="Cathedral", room_size=321.0, x_pos=0.1,
                             target_layout="5.1 (Standard)", bass_gain=1.4)
    got = convert.params_from_jax(p)
    assert type(got) is tparams.RenderParams
    assert dataclasses.asdict(got) == dataclasses.asdict(p)
    d = jparams.IRDraws.sample(np.random.default_rng(3),
                               geometry(jparams, "Room", 100.0, 8000))
    moved = convert.draws_from_jax(d)
    assert type(moved) is tparams.IRDraws
    for field in ("delays", "strengths", "noise"):
        np.testing.assert_array_equal(getattr(moved, field), getattr(d, field))
    # the draws packers read either class
    for a, b in zip(convert.draws_from_numpy(d), convert.draws_from_numpy(moved)):
        assert bool((a == b).all())
