"""The port's sequence-parallel ``render_long`` (``parallel/long_render.py``)
on a CPU block mesh of 8 shards: every case of ``tests/test_long_render.py``
(TestRenderLong) at 16 kHz and at most 2 s, against the port's own
single-device ``render`` at the JAX test's bounds — 2e-4 with air off, 1e-3
with air (block-grid air against the exact-length filter) or EQ (the
distributed exact-length transform) — and the sharded meter against the
single-device meter (0.02 LU, 1e-3 dB).

Two configurations also run through the JAX package's ``render_long`` on the
conftest's 8 virtual devices (each compiles for seconds): audio ≤ 2e-5,
metrics ≤ 1e-4 LU / dB, gaps recorded with ``record_property``.
"""

import jax
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.parallel import long_render as jlong
from audio_raytracing_studio_tpu.parallel import mesh as jmesh
from audio_raytracing_studio_tpu.params import RenderParams as JaxParams
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.metering import loudness
from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.parallel import long_render, mesh

torch.set_num_threads(1)

RATE = 16000
AIR_OFF_TOL = 2e-4
CONTRACT_TOL = 1e-3
JAX_TOL = 2e-5
JAX_METRIC_TOL = 1e-4


@pytest.fixture(scope="module")
def block_mesh():
    return mesh.make_mesh(data=1, block=8, devices=["cpu"] * 8)


def clip(rng, seconds, rate=RATE):
    t = np.arange(int(seconds * rate)) / rate
    return (0.4 * np.sin(2 * np.pi * 330 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def single(x, p, **kw):
    return pipeline.render(x, RATE, p, device="cpu", **kw)


def meter(out):
    m = loudness.audio_metrics(torch.from_numpy(np.ascontiguousarray(out.T)), RATE)
    return {k: float(v) for k, v in m.items()}


def test_matches_single_device_air_off(rng, block_mesh):
    x = clip(rng, 1.0)
    p = RenderParams(target_layout="Stereo", room_size=60.0, air_absorption=0.0)
    long = long_render.render_long(x, RATE, p, block_mesh, seed=3)
    want = single(x, p, seed=3)
    assert long.shape == want.shape
    assert np.max(np.abs(long - want)) < AIR_OFF_TOL


def test_matches_single_device_with_air(rng, block_mesh):
    x = clip(rng, 1.0)
    p = RenderParams(target_layout="Stereo", room_size=60.0, air_absorption=0.6)
    long = long_render.render_long(x, RATE, p, block_mesh, seed=3)
    # block-grid air gain against the exact-length circular filter: the 1e-3 contract
    assert np.max(np.abs(long - single(x, p, seed=3, fast_filters=False))) < CONTRACT_TOL


@pytest.mark.parametrize("layout", ["5.1 (Standard)", "7.1 (Surround)", "5.1.2 (Atmos Light)"])
def test_layouts_with_cross_block_delays(rng, block_mesh, layout):
    x = clip(rng, 0.8)
    p = RenderParams(target_layout=layout, room_size=60.0, air_absorption=0.0, z_pos=0.7)
    long = long_render.render_long(x, RATE, p, block_mesh, seed=1)
    want = single(x, p, seed=1)
    assert long.shape == want.shape
    assert np.max(np.abs(long - want)) < AIR_OFF_TOL, layout


def test_eq_matches_single_device_exact(rng, block_mesh):
    x = clip(rng, 1.0)
    p = RenderParams(target_layout="Stereo", room_size=60.0, air_absorption=0.0,
                     bass_gain=1.6, treble_gain=0.6)
    long = long_render.render_long(x, RATE, p, block_mesh, seed=3)
    exact = single(x, p, seed=3, fast_filters=False)
    assert long.shape == exact.shape
    assert np.max(np.abs(long - exact)) < CONTRACT_TOL
    unity = long_render.render_long(
        x, RATE, RenderParams(target_layout="Stereo", room_size=60.0, air_absorption=0.0),
        block_mesh, seed=3)
    assert np.max(np.abs(long - unity)) > 1e-3  # the EQ visibly acted


def test_eq_with_air_and_surround_matches_single_and_jax(rng, block_mesh, record_property):
    """EQ composed with fast air and cross-block layout delays; the JAX
    package's render_long on the same clip."""
    x = clip(rng, 0.8)
    kw = dict(target_layout="7.1 (Surround)", room_size=60.0, air_absorption=0.5,
              bass_gain=2.5, treble_gain=0.4, z_pos=0.7)
    long = long_render.render_long(x, RATE, RenderParams(**kw), block_mesh, seed=1)
    exact = single(x, RenderParams(**kw), seed=1, fast_filters=False)
    assert long.shape == exact.shape
    assert np.max(np.abs(long - exact)) < CONTRACT_TOL
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    want = jlong.render_long(x, RATE, JaxParams(**kw), jmesh.make_mesh(data=1, block=8),
                             seed=1)
    gap = float(np.abs(long - want).max())
    record_property("max_abs_vs_jax", gap)
    assert gap <= JAX_TOL


@pytest.mark.parametrize("eq", [False, True], ids=["no_eq", "eq"])
def test_external_ir_long(rng, block_mesh, eq):
    x = clip(rng, 0.8)
    ir = (rng.standard_normal((700, 2)) * 0.2).astype(np.float32)
    gains = dict(bass_gain=0.5, treble_gain=1.8) if eq else {}
    p = RenderParams(use_external_ir=True, target_layout="Stereo", dry_wet=0.7, **gains)
    long = long_render.render_long(x, RATE, p, block_mesh, external_ir=ir)
    want = single(x, p, external_ir=ir)
    assert long.shape == want.shape
    assert np.max(np.abs(long - want)) < (CONTRACT_TOL if eq else AIR_OFF_TOL)


def test_eq_requires_pow2_blocks(rng):
    three = mesh.make_mesh(data=1, block=3, devices=["cpu"] * 3)
    p = RenderParams(target_layout="Stereo", bass_gain=2.0)
    with pytest.raises(ValueError, match="power-of-two"):
        long_render.render_long(clip(rng, 0.3), RATE, p, three)


def test_delay_longer_than_block_is_refused(rng):
    """7.1's 12 ms side delay (192 samples at 16 kHz) cannot cross a shorter block."""
    x = clip(rng, 0.1)
    p = RenderParams(target_layout="7.1 (Surround)", room_size=1.0, air_absorption=0.0)
    spec, _ = pipeline.build_internal_spec(p, RATE, len(x))
    blocks = spec.len_out // 150 + 1  # blocks of at most 150 samples
    many = mesh.make_mesh(data=1, block=blocks, devices=["cpu"] * blocks)
    with pytest.raises(ValueError, match="exceeds the per-device block"):
        long_render.render_long(x, RATE, p, many)


def test_sharded_metrics_match_single_device_meter_and_jax(rng, block_mesh, record_property):
    x = clip(rng, 2.0)
    kw = dict(target_layout="Stereo", room_size=60.0, air_absorption=0.0)
    out, metrics = long_render.render_long(x, RATE, RenderParams(**kw), block_mesh, seed=3,
                                           with_metrics=True)
    ref = meter(out)
    assert metrics["lufs"] == pytest.approx(ref["lufs"], abs=0.02)
    assert metrics["true_peak_dbfs"] == pytest.approx(ref["true_peak_dbfs"], abs=1e-3)
    assert metrics["rms_dbfs"] == pytest.approx(ref["rms_dbfs"], abs=1e-3)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jout, jmetrics = jlong.render_long(x, RATE, JaxParams(**kw), jmesh.make_mesh(data=1, block=8),
                                       seed=3, with_metrics=True)
    gap = float(np.abs(out - jout).max())
    mgap = max(abs(metrics[k] - jmetrics[k]) for k in metrics)
    record_property("max_abs_vs_jax", gap)
    record_property("metrics_vs_jax", mgap)
    assert gap <= JAX_TOL and mgap <= JAX_METRIC_TOL


def test_sharded_metrics_silence(block_mesh):
    x = np.zeros(RATE, np.float32)
    p = RenderParams(target_layout="Stereo", room_size=60.0, air_absorption=0.0)
    _, metrics = long_render.render_long(x, RATE, p, block_mesh, with_metrics=True)
    assert metrics["lufs"] == float("-inf")
    assert metrics["true_peak_dbfs"] == float("-inf")


def test_block_count_does_not_change_the_render(rng):
    """Blocks of 2, 4 and 8 shards: the same clip within float32 round-off."""
    x = clip(rng, 1.0)
    p = RenderParams(target_layout="5.1 (Standard)", room_size=60.0, bass_gain=1.6,
                     treble_gain=0.7)
    outs = [long_render.render_long(x, RATE, p, mesh.make_mesh(data=1, block=d,
                                                               devices=["cpu"] * d), seed=2)
            for d in (2, 4, 8)]
    assert max(float(np.abs(o - outs[0]).max()) for o in outs[1:]) < 1e-5
