"""The port's device mesh on the CPU: ``parallel.mesh`` (``make_mesh``, the
collectives), the data-parallel ``render_batch(device_mesh=...)`` and
``RenderService(device_mesh=...)``.

The port's meshes are ``make_mesh(devices=["cpu"] * D)``; the JAX side runs
on the conftest's 8 virtual CPU devices.  Tolerances:

- port mesh against the port's meshless render: bit-equal (each shard runs
  the same per-row arithmetic as the whole batch; one thread);
- port mesh against the JAX package's mesh render on the same inputs:
  ≤ 2e-5 audio, PCM16 ≤ 1 LSB, metrics ≤ 1e-4 LU / dB (float32 round-off
  between two FFT libraries), each gap recorded with ``record_property``;
- against solo renders: the JAX tests' own bounds (2e-5, 0.01 LU).

The cases mirror ``tests/test_parallel.py`` (TestBatchedRender),
``tests/test_pallas_rir.py`` (the sharded bank with the full option matrix)
and ``tests/test_serving.py`` (buckets with a non-power-of-two data axis,
padding to the data axis, the full option matrix under a mesh).
"""

import jax
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.parallel import mesh as jmesh
from audio_raytracing_studio_tpu.parallel import sharding as jsharding
from audio_raytracing_studio_tpu.params import RenderParams as JaxParams
from audio_raytracing_studio_tpu.serving import RenderJob as JaxJob
from audio_raytracing_studio_tpu.serving import RenderService as JaxService
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.models import convert, pipeline
from audio_raytracing_studio_tpu_torch.parallel import mesh, sharding
from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService

torch.set_num_threads(1)

RATE = 16000
TOL = 2e-5
METRIC_TOL = 1e-4
CPU = torch.device("cpu")


def cpu_mesh(data=1, block=1):
    return mesh.make_mesh(data=data, block=block, devices=["cpu"] * (data * block))


def jax_mesh(data=1, block=1):
    if len(jax.devices()) < data * block:
        pytest.skip(f"needs {data * block} virtual devices")
    return jmesh.make_mesh(data=data, block=block, devices=jax.devices()[: data * block])


def short_clips(batch, seconds=0.3):
    t = np.arange(int(seconds * RATE)) / RATE
    return np.stack([(0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
                     for i in range(batch)])


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def metric_gap(got, want) -> float:
    return max(abs(g[k] - float(w[k])) for g, w in zip(got, want) for k in g
               if np.isfinite(g[k]))


# ------------------------------------------------------------------ make_mesh


def test_make_mesh_shape_and_axes():
    m = cpu_mesh(data=2, block=4)
    assert m.shape == {"data": 2, "block": 4}
    assert m.shape[mesh.DATA_AXIS] == 2 and m.size == 8
    assert m.axis_names == tuple(jmesh.make_mesh(data=2, block=4).axis_names)
    assert m.axis("block").devices == [CPU] * 4
    with pytest.raises(ValueError, match="unknown mesh axis"):
        m.axis("model")


@pytest.mark.parametrize("data, block", [(3, 2), (8, 2), (None, 3)])
def test_make_mesh_error_is_the_jax_packages(data, block):
    with pytest.raises(ValueError) as jax_err:
        jmesh.make_mesh(data=data, block=block, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as port_err:
        mesh.make_mesh(data=data, block=block, devices=["cpu"] * 8)
    assert str(port_err.value) == str(jax_err.value)


def test_make_mesh_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()


def test_mesh_rejects_mixed_device_types_and_wrong_meshes():
    with pytest.raises(ValueError, match="one type"):
        mesh.Mesh([[CPU, torch.device("meta")]])
    with pytest.raises(TypeError, match="Mesh"):
        mesh.check_mesh(object(), CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.Mesh([["cuda:0"]])
    assert mesh.check_mesh(cpu_mesh(2), CPU).shape["data"] == 2


# ---------------------------------------------------------------- collectives


def test_ppermute_copies_even_on_one_device():
    axis = cpu_mesh(block=4).axis("block")
    shards = [torch.full((3,), float(k)) for k in range(4)]
    out = mesh.ppermute(axis, shards, mesh.ring(axis))
    for k in range(4):
        assert torch.equal(out[k], torch.full((3,), float((k - 1) % 4)))
        assert out[k].data_ptr() != shards[(k - 1) % 4].data_ptr()
    shards[0].fill_(99.0)  # the sender's tensor changes; the received copy must not
    assert torch.equal(out[1], torch.zeros(3))
    # a partial permutation: shards that receive nothing get zeros
    part = mesh.ppermute(axis, shards, [(0, 2)])
    assert torch.equal(part[2], torch.full((3,), 99.0))
    assert all(torch.equal(part[k], torch.zeros(3)) for k in (0, 1, 3))


def test_reductions_scatter_gather_replicate():
    axis = cpu_mesh(block=4).axis("block")
    shards = [torch.tensor([float(k), -float(k)]) for k in range(4)]
    mx = mesh.pmax(axis, shards)
    sm = mesh.psum(axis, shards)
    for k in range(4):
        assert torch.equal(mx[k], torch.tensor([3.0, 0.0]))
        assert torch.equal(sm[k], torch.tensor([6.0, -6.0]))
    assert len({t.data_ptr() for t in mx}) == 4  # one fresh tensor per shard
    x = torch.arange(12.0).reshape(2, 6)
    parts = mesh.scatter(axis, torch.arange(8.0).reshape(1, 8))
    assert [p.tolist() for p in parts] == [[[0.0, 1.0]], [[2.0, 3.0]], [[4.0, 5.0]], [[6.0, 7.0]]]
    assert torch.equal(mesh.gather(axis, parts), torch.arange(8.0).reshape(1, 8))
    reps = mesh.replicate(axis, x)
    assert all(torch.equal(r, x) and r.data_ptr() != x.data_ptr() for r in reps)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.scatter(axis, torch.zeros(6))


def test_shard_rows_error_is_the_jax_packages():
    assert mesh.shard_rows(cpu_mesh(4), 8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                slice(6, 8)]
    with pytest.raises(ValueError, match="batch 3 not divisible by data axis 8"):
        mesh.shard_rows(cpu_mesh(8), 3)


def test_initialize_distributed_single_process():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- render_batch on a mesh


@pytest.mark.parametrize("data", [2, 4, 8])
def test_mesh_render_is_bit_equal_to_meshless(data):
    clips = short_clips(8)
    p = RenderParams(target_layout="5.1 (Standard)", room_size=50.0)
    want = sharding.render_batch(clips, RATE, p, device="cpu")
    got = sharding.render_batch(clips, RATE, p, device="cpu", device_mesh=cpu_mesh(data))
    assert got.shape == (8, want.shape[1], 6)
    assert np.array_equal(got, want)


def test_sharded_over_mesh_matches_jax_mesh_and_solo(record_property):
    """tests/test_parallel.py::test_sharded_over_mesh, on both packages."""
    clips = short_clips(8)
    p = RenderParams(target_layout="5.1 (Standard)", room_size=50.0)
    jp = JaxParams(target_layout="5.1 (Standard)", room_size=50.0)
    got = sharding.render_batch(clips, RATE, p, device="cpu", device_mesh=cpu_mesh(8))
    want = np.asarray(jsharding.render_batch(clips, RATE, jp, device_mesh=jax_mesh(8)))
    gap = max_abs(got, want)
    record_property("max_abs_vs_jax", gap)
    assert gap <= TOL
    single = pipeline.render(clips[3], RATE, p, seed=3, device="cpu")
    assert max_abs(got[3], single) <= TOL


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "jnp"])
def test_full_option_matrix_on_a_mesh(record_property, bank):
    """PCM16, masked metrics and padded EQ-on clips over data=4, with pad rows
    dropped and the result fetched later — against the meshless render
    (bit-equal) and the JAX package's mesh render (its jnp backend)."""
    clips = short_clips(8, seconds=0.5)
    true_lens = [clips.shape[1] - (0, 999, 555, 0, 131, 0, 777, 5)[i] for i in range(8)]
    for b, tl in enumerate(true_lens):
        clips[b, tl:] = 0.0  # bucket padding is zeros by contract
    kw = [dict(target_layout="Stereo", bass_gain=1.8, treble_gain=0.5),
          dict(target_layout="Stereo")]
    params = [RenderParams(**kw[i % 2]) for i in range(8)]
    jparams = [JaxParams(**kw[i % 2]) for i in range(8)]
    common = dict(seeds=list(range(8)), with_metrics=True, pcm16_output=True,
                  clip_lengths=true_lens)
    backend = "bank" if bank else "jnp"
    fetch = sharding.render_batch(clips, RATE, params, device="cpu", device_mesh=cpu_mesh(4),
                                  ir_backend=backend, real_batch=7, async_results=True,
                                  **common)
    assert callable(fetch)
    q, metrics = fetch()
    want, want_metrics = sharding.render_batch(clips, RATE, params, device="cpu",
                                               ir_backend=backend, **common)
    assert q.dtype == np.int16 and q.shape == (7,) + want.shape[1:]
    assert np.array_equal(q, want[:7]) and metrics == want_metrics[:7]
    jq, jmetrics = jsharding.render_batch(clips, RATE, jparams, device_mesh=jax_mesh(4),
                                          **common)
    gap, mgap = lsb(q, np.asarray(jq)[:7]), metric_gap(metrics, jmetrics[:7])
    record_property("lsb_vs_jax", gap)
    record_property("metrics_vs_jax", mgap)
    assert gap <= 1 and mgap <= METRIC_TOL


def test_external_ir_on_a_mesh(rng, record_property):
    clips = short_clips(4, seconds=0.5)
    ir = (rng.standard_normal((800, 2)) * 0.2).astype(np.float32)
    dws = (0.3, 0.6, 0.9, 0.45)
    params = [RenderParams(use_external_ir=True, target_layout="Stereo", dry_wet=d) for d in dws]
    jparams = [JaxParams(use_external_ir=True, target_layout="Stereo", dry_wet=d) for d in dws]
    got, metrics = sharding.render_batch(clips, RATE, params, external_ir=ir, with_metrics=True,
                                         device="cpu", device_mesh=cpu_mesh(2))
    want, want_metrics = sharding.render_batch(clips, RATE, params, external_ir=ir,
                                               with_metrics=True, device="cpu")
    assert np.array_equal(got, want) and metrics == want_metrics
    jout, jmetrics = jsharding.render_batch(clips, RATE, jparams, external_ir=ir,
                                            with_metrics=True, device_mesh=jax_mesh(2))
    gap = max_abs(got, jout)
    record_property("max_abs_vs_jax", gap)
    assert gap <= TOL and metric_gap(metrics, jmetrics) <= METRIC_TOL


@pytest.mark.parametrize("external", [False, True], ids=["internal", "external"])
def test_batch_divisibility_rejected_like_jax(rng, external):
    """Both paths give the JAX package's ValueError for an uneven batch."""
    clips = short_clips(3)
    ir = rng.standard_normal((400, 2)).astype(np.float32)
    kw = dict(use_external_ir=True, target_layout="Stereo") if external else dict(
        target_layout="Stereo")
    extra = dict(external_ir=ir) if external else {}
    with pytest.raises(ValueError) as jax_err:
        jsharding.render_batch(clips, RATE, JaxParams(**kw), device_mesh=jax_mesh(8), **extra)
    with pytest.raises(ValueError) as port_err:
        sharding.render_batch(clips, RATE, RenderParams(**kw), device="cpu",
                              device_mesh=cpu_mesh(8), **extra)
    assert str(port_err.value) == str(jax_err.value) == "batch 3 not divisible by data axis 8"


def test_mesh_and_device_must_agree():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.render_batch(short_clips(2), RATE, RenderParams(), device_mesh=cpu_mesh(2))
    meta = mesh.Mesh([[torch.device("meta")]])
    with pytest.raises(ValueError, match="meta"):
        sharding.render_batch(short_clips(2), RATE, RenderParams(), device="cpu",
                              device_mesh=meta)


@pytest.mark.parametrize("field,values", [("bass_gain", (1.0, 1.6)),
                                          ("air_absorption", (0.0, 0.6)),
                                          ("early_level", (0.0, 0.7))])
def test_value_flag_sweep_over_a_mesh(field, values):
    """Flags that widen batch-wide still widen when the batch is split: each
    shard renders with the whole batch's spec, bit-equal to the meshless batch."""
    clips = short_clips(4, seconds=0.4)
    params = [RenderParams(target_layout="Stereo", room_size=50.0, **{field: v})
              for v in values * 2]
    want = sharding.render_batch(clips, RATE, params, device="cpu")
    got = sharding.render_batch(clips, RATE, params, device="cpu", device_mesh=cpu_mesh(4))
    assert np.array_equal(got, want)
    solo = pipeline.render(clips[1], RATE, params[1], seed=1, device="cpu")
    assert max_abs(got[1], solo) <= 1e-4


# ------------------------------------------------------ RenderService on a mesh


def make_clip(i, seconds=0.3):
    t = np.arange(int(seconds * RATE)) / RATE
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(np.float32)


def staged(svc, jobs):
    futs = [svc.submit(j) for j in jobs]
    svc.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        svc.stop()


def test_buckets_are_fixed_points_with_non_pow2_data_axis():
    jsvc = JaxService(max_batch=8, device_mesh=jax_mesh(3), start=False)
    svc = RenderService(max_batch=8, device_mesh=cpu_mesh(3), device="cpu", start=False)
    try:
        assert svc.bucket_sizes() == jsvc.bucket_sizes() == [3, 6, 9]
        for b in svc.bucket_sizes():
            assert svc._batch_pad(b) == 0, b
        sizes = (1, 2, 3, 4, 6, 7, 8)
        assert ([b + svc._batch_pad(b) for b in sizes]
                == [b + jsvc._batch_pad(b) for b in sizes] == [3, 3, 3, 6, 6, 9, 9])
    finally:
        svc.stop()
        jsvc.stop()


def test_mesh_batch_pads_to_data_axis():
    """3 jobs on data=8 → one group of 3 padded to 8; each job equals its row
    of the direct mesh render of that padded batch, bit for bit."""
    svc = RenderService(max_batch=8, max_wait_ms=50, device_mesh=cpu_mesh(8), device="cpu",
                        start=False)
    p = RenderParams(target_layout="Stereo", room_size=50.0)
    clips = [make_clip(i) for i in range(3)]
    results = staged(svc, [RenderJob(c, RATE, p, seed=i) for i, c in enumerate(clips)])
    assert svc.stats()["batch_sizes"] == [3]
    n_bucket = sharding.bucket_length(len(clips[0]), RATE)
    padded = np.zeros((8, n_bucket), np.float32)
    for i, c in enumerate(clips):
        padded[i, : len(c)] = c
    direct = sharding.render_batch(padded, RATE, p, seeds=[0, 1, 2] + [0] * 5,
                                   clip_lengths=[len(c) for c in clips] + [n_bucket] * 5,
                                   device_mesh=cpu_mesh(8), device="cpu")
    for i, c in enumerate(clips):
        assert np.array_equal(results[i].audio, direct[i, : results[i].audio.shape[0]])


def test_full_option_service_matrix_against_jax(record_property):
    """tests/test_serving.py::test_pallas_mesh_full_option_matrix: PCM16,
    metrics masked to each true span, EQ on an off-grid length, under a mesh
    — the port's service (bank) beside the JAX one (its jnp backend), the
    same staged jobs."""
    p_eq = dict(target_layout="Stereo", room_size=50.0, bass_gain=1.7, treble_gain=0.6)
    p_flat = dict(target_layout="Stereo", room_size=50.0)
    clips = [make_clip(0, seconds=0.21), make_clip(1, seconds=0.3)]
    jobs = [JaxJob(c, RATE, JaxParams(**kw), seed=i, with_metrics=True)
            for i, (c, kw) in enumerate(zip(clips, (p_eq, p_flat)))]
    jsvc = JaxService(device_mesh=jax_mesh(8), pcm16_output=True, max_batch=8,
                      max_wait_ms=50, start=False)
    want = staged(jsvc, jobs)
    svc = RenderService(device_mesh=cpu_mesh(8), pcm16_output=True, max_batch=8,
                        max_wait_ms=50, device="cpu", start=False)
    got = staged(svc, [convert.job_from_jax(j) for j in jobs])
    assert svc.stats()["batch_sizes"] == jsvc.stats()["batch_sizes"] == [2]
    gap = max(lsb(g.audio, w.audio) for g, w in zip(got, want))
    mgap = metric_gap([g.metrics for g in got], [w.metrics for w in want])
    record_property("lsb_vs_jax", gap)
    record_property("metrics_vs_jax", mgap)
    for g, w in zip(got, want):
        assert g.audio.dtype == np.int16 and g.audio.shape == np.asarray(w.audio).shape
    assert gap <= 1 and mgap <= METRIC_TOL
    # and each job against its unpadded solo render (the JAX test's bounds)
    for i, (c, kw) in enumerate(zip(clips, (p_eq, p_flat))):
        solo, sm = pipeline.render(c, RATE, RenderParams(**kw), seed=i, return_metrics=True,
                                   device="cpu")
        assert got[i].metrics["lufs"] == pytest.approx(sm["lufs"], abs=0.05)


def test_service_mesh_warm_and_rejects():
    svc = RenderService(max_batch=4, device_mesh=cpu_mesh(2), device="cpu", start=False)
    try:
        job = RenderJob(make_clip(0), RATE, RenderParams(target_layout="Stereo"))
        assert svc.warm(job) == [2, 4]
    finally:
        svc.stop()
    with pytest.raises(TypeError, match="Mesh"):
        RenderService(device_mesh=object(), device="cpu", start=False)
