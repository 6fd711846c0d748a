"""The port's serving layer on the CPU: ``RenderService`` over
``render_batch(async_results=True)``.

Two kinds of checks, all with ``device="cpu"`` (the plain PyTorch path) and
clips of at most 0.3 s at 16 kHz:

- the same staged jobs through the JAX package's ``RenderService`` and the
  port's give the same batch sizes, audio within 2e-5 (PCM16 within 1 LSB —
  float round-off between two FFT libraries) and metrics within 0.01 LU
  (PARITY.md's meter bound); the measured gaps are recorded with
  ``record_property``;
- the port-only cases mirror ``tests/test_serving.py``: every job equals
  what it would have rendered alone, trimmed to and metered on its true
  span, whatever group it rode in.

Every wait on a future has a timeout.
"""

import dataclasses
import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.params import RenderParams as JaxParams
from audio_raytracing_studio_tpu.serving import RenderJob as JaxJob
from audio_raytracing_studio_tpu.serving import RenderService as JaxService
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.models import convert, pipeline
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.parallel import sharding
from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderResult, RenderService
from audio_raytracing_studio_tpu_torch.serving import batcher
from audio_raytracing_studio_tpu_torch.utils import kernels, wavio

torch.set_num_threads(1)

RATE = 16000
TOL = 2e-5
LU_TOL = 0.01
BASE = dict(target_layout="Stereo", room_size=50.0)


def make_clip(i, seconds=0.3, rate=RATE):
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(np.float32)


def service(**kw):
    kw.setdefault("device", "cpu")
    return RenderService(**kw)


def solo(clip, p, seed, **kw):
    return pipeline.render(clip, RATE, p, seed=seed, device="cpu", **kw)


def padded_reference(clip, p, seed, external_ir=None):
    """What a bucketed job must produce: the clip rendered at its padded
    bucket length, trimmed back to the true span clip_len + ir_len − 1."""
    n_bucket = sharding.bucket_length(len(clip), RATE)
    out = solo(np.pad(clip, (0, n_bucket - len(clip))), p, seed, external_ir=external_ir)
    return out[: len(clip) + out.shape[0] - n_bucket]


def wait_all(futures, timeout=300):
    return [f.result(timeout=timeout) for f in futures]


def staged(svc, jobs):
    """Submit before the worker starts, so the groups are deterministic."""
    futs = [svc.submit(j) for j in jobs]
    svc.start()
    try:
        return wait_all(futs)
    finally:
        svc.stop()


# ---------------------------------------------------------------- vs JAX


def parity_jobs(rng):
    """One internal signature (a value sweep, one job with EQ on, metrics
    on) and one external-IR signature: two compiled programs on the JAX
    side."""
    ir = (0.3 * rng.standard_normal((400, 2))).astype(np.float32)
    sweep = [
        dict(material="Stein", diffusion=0.2),
        dict(material="Teppich", diffusion=0.8, x_pos=0.9),
        dict(dry_wet=0.9),
        dict(bass_gain=1.7, treble_gain=0.6),
        dict(air_absorption=0.7, y_pos=0.1),
    ]
    jobs = [JaxJob(make_clip(i), RATE, JaxParams(**BASE, **kw), seed=i, with_metrics=True)
            for i, kw in enumerate(sweep)]
    jobs += [JaxJob(make_clip(7 + i, seconds=0.27), RATE,
                    JaxParams(use_external_ir=True, target_layout="Stereo"), seed=i,
                    with_metrics=True, external_ir=ir) for i in range(2)]
    return jobs


@pytest.mark.parametrize("pcm16", [False, True], ids=["float32", "pcm16"])
def test_same_jobs_through_jax_and_port_services(rng, record_property, pcm16):
    jobs = parity_jobs(rng)
    jax_svc = JaxService(max_batch=8, max_wait_ms=50, pcm16_output=pcm16, start=False)
    want = staged(jax_svc, jobs)
    port_svc = service(max_batch=8, max_wait_ms=50, pcm16_output=pcm16, start=False)
    got = staged(port_svc, [convert.job_from_jax(j) for j in jobs])
    assert port_svc.stats()["batch_sizes"] == jax_svc.stats()["batch_sizes"] == [5, 2]
    worst_audio, worst_lu = 0.0, 0.0
    for g, w in zip(got, want):
        w_audio = np.asarray(w.audio)
        assert g.audio.shape == w_audio.shape and g.audio.dtype == w_audio.dtype
        if pcm16:
            gap = int(np.abs(g.audio.astype(np.int32) - w_audio.astype(np.int32)).max())
            assert gap <= 1
        else:
            gap = float(np.abs(g.audio - w_audio).max())
            assert gap <= TOL
        worst_audio = max(worst_audio, gap)
        for k in ("lufs", "true_peak_dbfs", "rms_dbfs"):
            assert g.metrics[k] == pytest.approx(float(w.metrics[k]), abs=LU_TOL), k
            worst_lu = max(worst_lu, abs(g.metrics[k] - float(w.metrics[k])))
    record_property("port_vs_jax_service_audio_gap", worst_audio)
    record_property("port_vs_jax_service_metric_gap", worst_lu)


def test_job_from_jax_carries_every_field(rng):
    ir = rng.standard_normal((40, 2)).astype(np.float32)
    j = JaxJob(make_clip(0), RATE, JaxParams(hall_type="Plate", x_pos=0.2), seed=9,
               with_metrics=True, external_ir=ir, external_ir_rate=8000)
    p = convert.job_from_jax(j)
    assert isinstance(p, RenderJob) and isinstance(p.params, RenderParams)
    assert dataclasses.asdict(p.params) == dataclasses.asdict(j.params)
    assert p.audio is j.audio and p.external_ir is ir
    assert (p.rate, p.seed, p.with_metrics, p.external_ir_rate) == (RATE, 9, True, 8000)


# ---------------------------------------------------------------- batching


def test_single_job_roundtrip():
    svc = service(max_batch=4, max_wait_ms=20)
    try:
        clip, p = make_clip(0), RenderParams(**BASE)
        res = svc.render(RenderJob(clip, RATE, p, seed=3), timeout=300)
    finally:
        svc.stop()
    assert isinstance(res, RenderResult) and res.rate == RATE and res.metrics is None
    expect = padded_reference(clip, p, seed=3)
    assert res.audio.shape == expect.shape
    np.testing.assert_allclose(res.audio, expect, atol=TOL)


def test_value_sweep_batches_into_one_dispatch():
    """Different material / diffusion / position / EQ / seed jobs share one
    batch, and each equals its UNPADDED solo render: the padded EQ-on clips
    are EQ'd at their true lengths, the linear stages are padding-exact."""
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    ps = [
        RenderParams(material="Stein", diffusion=0.2, **BASE),
        RenderParams(material="Teppich", diffusion=0.8, x_pos=0.9, **BASE),
        RenderParams(dry_wet=0.9, **BASE),
        RenderParams(bass_gain=1.7, treble_gain=0.6, **BASE),
        RenderParams(bass_gain=0.4, **BASE),
    ]
    clips = [make_clip(i) for i in range(5)]
    results = staged(svc, [RenderJob(c, RATE, p, seed=i)
                           for i, (c, p) in enumerate(zip(clips, ps))])
    assert svc.stats()["batch_sizes"] == [5]
    for i, (c, p) in enumerate(zip(clips, ps)):
        np.testing.assert_allclose(results[i].audio, solo(c, p, i), atol=TOL)


@pytest.mark.parametrize("batch, padded", [
    (1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32), (33, 48), (44, 48), (45, 48), (48, 48),
])
def test_batch_size_buckets(batch, padded):
    svc = service(max_batch=48, start=False)
    assert batch + svc._batch_pad(batch) == padded
    svc.stop()


def test_buckets_below_a_power_of_two_cap():
    svc = service(max_batch=6, start=False)
    assert [b + svc._batch_pad(b) for b in (1, 2, 3, 5, 6)] == [1, 2, 4, 6, 6]
    svc.stop()


@pytest.mark.parametrize("max_batch, sizes", [
    (48, [1, 2, 4, 8, 16, 32, 48]), (6, [1, 2, 4, 6]), (16, [1, 2, 4, 8, 16]), (1, [1]),
])
def test_bucket_sizes_are_fixed_points(max_batch, sizes):
    svc = service(max_batch=max_batch, start=False)
    assert svc.bucket_sizes() == sizes
    assert all(svc._batch_pad(b) == 0 for b in sizes)
    svc.stop()


@pytest.fixture
def spy(monkeypatch):
    """Record (padded batch, real_batch, async_results) of every
    ``render_batch`` the batcher makes."""
    calls = []
    real = sharding.render_batch

    def recording(clips, rate, params, **kw):
        calls.append((clips.shape[0], kw.get("real_batch"), kw.get("async_results")))
        return real(clips, rate, params, **kw)

    monkeypatch.setattr(sharding, "render_batch", recording)
    return calls


def test_warm_dispatches_every_bucket_once(spy):
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    clip, p = make_clip(0), RenderParams(**BASE)
    assert svc.warm(RenderJob(clip, RATE, p)) == [1, 2, 4, 8]
    assert spy == [(1, 1, True), (2, 2, True), (4, 4, True), (8, 8, True)]
    assert svc.stats()["batch_sizes"] == []  # warm dispatches are not traffic
    fut = svc.submit(RenderJob(clip, RATE, p, seed=3))
    svc.start()
    result = fut.result(timeout=120)
    svc.stop()
    np.testing.assert_allclose(result.audio, padded_reference(clip, p, seed=3), atol=TOL)


def test_warm_normalizes_explicit_sizes(spy):
    svc = service(max_batch=8, start=False)
    assert svc.warm(RenderJob(make_clip(0), RATE, RenderParams(**BASE)), sizes=[3, 8]) == [4, 8]
    assert [c[:2] for c in spy] == [(4, 4), (8, 8)]
    svc.stop()


def test_dispatch_pads_batch_and_drops_pad_rows(spy):
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    p = RenderParams(**BASE)
    clips = [make_clip(i) for i in range(3)]
    results = staged(svc, [RenderJob(c, RATE, p, seed=i) for i, c in enumerate(clips)])
    assert spy == [(4, 3, True)]
    st = svc.stats()
    assert st["batch_sizes"] == [3]  # stats report TRUE sizes
    # bytes actually copied up: the padded batch at the bucket length (mono float32)
    n_bucket = sharding.bucket_length(len(clips[0]), RATE)
    assert st["dispatched_input_bytes_total"] == 4 * n_bucket * 4
    for i, c in enumerate(clips):
        np.testing.assert_allclose(results[i].audio, padded_reference(c, p, seed=i), atol=TOL)


def test_padding_is_exact_on_the_linear_path():
    svc = service(max_batch=2, max_wait_ms=20)
    try:
        clip = make_clip(2)  # 4800 samples → bucket 8000: real padding
        p = RenderParams(air_absorption=0.0, **BASE)
        res = svc.render(RenderJob(clip, RATE, p, seed=5), timeout=300)
    finally:
        svc.stop()
    unpadded = solo(clip, p, 5)
    assert res.audio.shape == unpadded.shape
    np.testing.assert_allclose(res.audio, unpadded, atol=TOL)


def test_eq_job_matches_unpadded_solo():
    svc = service(max_batch=2, max_wait_ms=20)
    try:
        clip = make_clip(2)
        p = RenderParams(bass_gain=4.0, treble_gain=0.3, **BASE)
        res = svc.render(RenderJob(clip, RATE, p, seed=5), timeout=300)
    finally:
        svc.stop()
    unpadded = solo(clip, p, 5)
    assert res.audio.shape == unpadded.shape
    np.testing.assert_allclose(res.audio, unpadded, atol=TOL)


def test_distinct_specs_split_batches():
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    room, plate = RenderParams(**BASE), RenderParams(hall_type="Plate", **BASE)
    staged(svc, [RenderJob(make_clip(i), RATE, p, seed=i)
                 for i, p in enumerate([room, plate, room, plate])])
    assert sorted(svc.stats()["batch_sizes"]) == [2, 2]
    assert svc.stats()["jobs_done"] == 4


def test_metrics_flag_and_length_bucket_split_batches():
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    p = RenderParams(**BASE)
    jobs = [RenderJob(make_clip(0), RATE, p), RenderJob(make_clip(1), RATE, p, with_metrics=True),
            RenderJob(make_clip(2, seconds=0.6), RATE, p)]
    assert len({svc._prepare(j).key for j in jobs}) == 3
    results = staged(svc, jobs)
    assert sorted(svc.stats()["batch_sizes"]) == [1, 1, 1]
    assert [r.metrics is not None for r in results] == [False, True, False]


def test_mono_stereo_and_wider_jobs_share_a_group():
    """The submitted array is kept as it is (mono duplicated, extra channels
    dropped only when the group is stacked); each job equals its solo render."""
    rng = np.random.default_rng(3)
    p = RenderParams(**BASE)
    audios = [(0.2 * rng.standard_normal((4000, c))).astype(np.float32) for c in (1, 2, 3)]
    audios.append(audios[0][:, 0])  # 1-D mono
    svc = service(max_batch=4, max_wait_ms=50, start=False)
    results = staged(svc, [RenderJob(a, RATE, p, seed=i) for i, a in enumerate(audios)])
    assert svc.stats()["batch_sizes"] == [4]
    for i, a in enumerate(audios):
        np.testing.assert_allclose(results[i].audio, solo(a, p, i), atol=TOL)


def test_partial_batch_dispatches_on_deadline():
    svc = service(max_batch=8, max_wait_ms=80)
    try:
        p = RenderParams(**BASE)
        wait_all([svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)])
        assert svc.stats()["batch_sizes"] == [2]
    finally:
        svc.stop()


def test_metrics_measured_on_true_span():
    clip, p = make_clip(1, seconds=0.3), RenderParams(**BASE)
    svc = service(max_batch=2, max_wait_ms=20)
    try:
        res = svc.render(RenderJob(clip, RATE, p, seed=7, with_metrics=True), timeout=300)
    finally:
        svc.stop()
    n_bucket = sharding.bucket_length(len(clip), RATE)
    padded = np.zeros((1, n_bucket), np.float32)
    padded[0, : len(clip)] = clip
    _, expect = sharding.render_batch(padded, RATE, p, seeds=[7], with_metrics=True,
                                      clip_lengths=[len(clip)], device="cpu")
    assert res.metrics == expect[0]
    # and the masked meter agrees with the meter on the trimmed solo render
    _, solo_m = solo(clip, p, 7, return_metrics=True)
    for k, v in solo_m.items():
        assert res.metrics[k] == pytest.approx(v, abs=LU_TOL), k


def test_failed_batch_is_isolated(monkeypatch):
    svc = service(max_batch=2, max_wait_ms=20, start=False)
    p = RenderParams(**BASE)

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(sharding, "render_batch", boom)
    futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)]
    svc.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="injected device failure"):
            f.result(timeout=60)
    assert svc.stats()["jobs_failed"] == 2 and svc.stats()["inflight_input_bytes"] == 0
    monkeypatch.undo()
    res = svc.render(RenderJob(make_clip(9), RATE, p, seed=9), timeout=300)  # the worker survived
    svc.stop()
    assert np.isfinite(res.audio).all()


def test_fetch_failure_is_isolated_to_its_group(monkeypatch):
    svc = service(max_batch=2, max_wait_ms=20, start=False)
    p = RenderParams(**BASE)

    def bad_dispatch(*a, **k):
        assert k.get("async_results"), "the batcher must dispatch asynchronously"

        def bad_fetch():
            raise RuntimeError("injected copy failure")

        return bad_fetch

    monkeypatch.setattr(sharding, "render_batch", bad_dispatch)
    futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)]
    svc.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="injected copy failure"):
            f.result(timeout=60)
    assert svc.stats()["jobs_failed"] == 2
    monkeypatch.undo()
    res = svc.render(RenderJob(make_clip(9), RATE, p, seed=9), timeout=300)  # both threads survived
    svc.stop()
    assert np.isfinite(res.audio).all()


def test_external_ir_jobs_batch_by_ir_digest(rng):
    ir = (0.3 * rng.standard_normal((400, 2))).astype(np.float32)
    other = (0.3 * rng.standard_normal((400, 2))).astype(np.float32)
    p = RenderParams(use_external_ir=True, target_layout="Stereo")
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    clips = [make_clip(i) for i in range(3)]
    irs = [ir, ir.copy(), other]
    results = staged(svc, [RenderJob(c, RATE, p, seed=i, external_ir=x)
                           for i, (c, x) in enumerate(zip(clips, irs))])
    assert sorted(svc.stats()["batch_sizes"]) == [1, 2]
    for i, (c, x) in enumerate(zip(clips, irs)):
        np.testing.assert_allclose(results[i].audio, padded_reference(c, p, i, external_ir=x),
                                   atol=TOL)


def test_external_ir_at_another_rate_is_resampled_at_submit(rng):
    ir = (0.3 * rng.standard_normal((220, 2))).astype(np.float32)
    p = RenderParams(use_external_ir=True, target_layout="Stereo")
    svc = service(max_batch=2, max_wait_ms=20)
    try:
        clip = make_clip(0)
        res = svc.render(RenderJob(clip, RATE, p, external_ir=ir, external_ir_rate=8000),
                         timeout=300)
    finally:
        svc.stop()
    expect = pipeline.render(clip, RATE, p, external_ir=ir, external_ir_rate=8000, device="cpu")
    np.testing.assert_allclose(res.audio, expect, atol=TOL)


@pytest.mark.parametrize("job, match", [
    (lambda: RenderJob(make_clip(0), RATE, RenderParams(use_external_ir=True)), "external_ir"),
    (lambda: RenderJob(make_clip(0), RATE, RenderParams(use_external_ir=True),
                       external_ir=np.zeros((400, 1), np.float32)), "stereo"),
    (lambda: RenderJob(make_clip(0), 0, RenderParams()), "rate"),
    (lambda: RenderJob(np.zeros((0,), np.float32), RATE, RenderParams()), "audio"),
    (lambda: RenderJob(np.zeros((2, 3, 4), np.float32), RATE, RenderParams()), "audio"),
    (lambda: RenderJob(make_clip(0), RATE, {"hall_type": "Room"}), "RenderParams"),
], ids=["no-ir", "mono-ir", "rate-0", "empty", "3-d", "params-dict"])
def test_invalid_jobs_fail_fast_at_submit(job, match):
    svc = service(max_batch=2, max_wait_ms=20, start=False)
    with pytest.raises(ValueError, match=match):
        svc.submit(job())
    assert svc.stats()["queued"] == 0 and svc.stats()["inflight_input_bytes"] == 0
    svc.stop()


@pytest.mark.parametrize("external", [False, True], ids=["internal", "external-ir"])
def test_long_jobs_route_to_streaming(spy, external, record_property):
    """Past ``streaming_threshold_s`` a job is a singleton group rendered by
    ``render_streaming`` (never ``render_batch``): the same audio and metrics
    as the direct call, bit for bit, and within float round-off of the JAX
    service's routed job (``tests/test_serving.py``'s routing case).  Its
    bytes are counted once and given back once."""
    from audio_raytracing_studio_tpu_torch.parallel.streaming import render_streaming

    clip = make_clip(4, seconds=0.8)
    # exact filters, air off: the JAX side compiles no Bluestein transform
    kw = dict(target_layout="Stereo", room_size=50.0, air_absorption=0.0)
    ir = (np.random.default_rng(8).standard_normal((300, 2)) * 0.2).astype(np.float32)
    if external:
        kw = dict(use_external_ir=True, target_layout="Stereo", dry_wet=0.6)
    p = RenderParams(**kw)
    job = RenderJob(clip, RATE, p, seed=6, with_metrics=True,
                    external_ir=ir if external else None, external_ir_rate=22050)
    svc = service(max_batch=4, max_wait_ms=20, streaming_threshold_s=0.5, chunk_seconds=0.25)
    try:
        res = svc.render(job, timeout=300)
        stats = svc.stats()
    finally:
        svc.stop()
    assert spy == [] and stats["batch_sizes"] == [1] and stats["jobs_done"] == 1
    assert stats["dispatched_input_bytes_total"] == clip.nbytes + (
        pipeline.prepare_external_ir(ir, 22050, RATE).numpy().nbytes if external else 0)
    assert stats["inflight_input_bytes"] == 0
    assert stats["fetched_result_bytes_total"] == res.audio.nbytes
    assert stats["retained_result_bytes"] == res.audio.nbytes and stats["retained_results"] == 1
    extra = dict(external_ir=ir, external_ir_rate=22050) if external else {}
    expect, expect_m = render_streaming(clip, RATE, p, seed=6, chunk_seconds=0.25,
                                        with_metrics=True, fast_filters=False, device="cpu",
                                        **extra)
    assert res.audio.dtype == np.float32 and np.array_equal(res.audio, expect)
    assert res.metrics == expect_m
    if external:
        return
    jsvc = JaxService(max_batch=4, max_wait_ms=20, streaming_threshold_s=0.5,
                      chunk_seconds=0.25)
    try:
        # without metrics: the JAX meter's compile is the costliest part here
        want = jsvc.render(JaxJob(clip, RATE, JaxParams(**kw), seed=6), timeout=300)
        assert jsvc.stats()["batch_sizes"] == [1]
    finally:
        jsvc.stop()
    gap = float(np.abs(res.audio - np.asarray(want.audio)).max())
    record_property("port_vs_jax_streamed_gap", gap)
    assert gap <= TOL
    del res
    gc.collect()
    assert svc.stats()["retained_result_bytes"] == 0


def test_warm_rejects_streaming_jobs():
    long_clip = np.zeros(RATE, np.float32)  # 1 s > 0.5 s
    for make in (lambda: JaxService(max_batch=4, streaming_threshold_s=0.5, start=False),
                 lambda: service(max_batch=4, streaming_threshold_s=0.5, start=False)):
        svc = make()
        try:
            job_cls = JaxJob if isinstance(svc, JaxService) else RenderJob
            params = JaxParams() if isinstance(svc, JaxService) else RenderParams()
            with pytest.raises(ValueError, match="streaming-routed jobs have no batch buckets"):
                svc.warm(job_cls(long_clip, RATE, params))
        finally:
            svc.stop()


def test_threshold_none_renders_long_clips_single_shot(spy):
    free = service(max_batch=1, max_wait_ms=10, streaming_threshold_s=None)
    try:
        assert free.render(RenderJob(np.zeros(RATE, np.float32), RATE, RenderParams(**BASE)),
                           timeout=300)
    finally:
        free.stop()
    assert len(spy) == 1


def test_backpressure_and_stopped_service():
    svc = service(max_batch=2, max_wait_ms=20, max_queued=2, start=False)
    p = RenderParams(**BASE)
    f1 = svc.submit(RenderJob(make_clip(0), RATE, p))
    svc.submit(RenderJob(make_clip(1), RATE, p))
    with pytest.raises(RuntimeError, match="overloaded"):
        svc.submit(RenderJob(make_clip(2), RATE, p))
    svc.stop()  # never started: queued futures fail, not hang
    with pytest.raises(RuntimeError, match="stopped"):
        f1.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(RenderJob(make_clip(3), RATE, p))


@pytest.mark.parametrize("kw, error", [
    (dict(max_batch=0), ValueError), (dict(max_queued=0), ValueError),
    (dict(pipeline_depth=0), ValueError), (dict(ir_backend="pallas"), ValueError),
    (dict(device_mesh=object()), TypeError),
], ids=["max_batch", "max_queued", "depth", "ir_backend", "mesh"])
def test_constructor_rejects(kw, error):
    with pytest.raises(error):
        service(start=False, **kw)


def test_cuda_service_without_a_card_raises_before_any_job():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderService(start=False)  # device="cuda" is the default


def test_pipelined_matches_serial_bit_exactly():
    p = RenderParams(bass_gain=1.4, **BASE)
    jobs = [(make_clip(i, seconds=0.1 + 0.1 * (i % 3)), i % 2 == 0, i) for i in range(6)]

    def run(depth):
        svc = service(max_batch=2, max_wait_ms=20, pipeline_depth=depth)
        try:
            futs = [svc.submit(RenderJob(c, RATE, p, seed=s, with_metrics=wm))
                    for c, wm, s in jobs]
            return wait_all(futs), svc.stats()
        finally:
            svc.stop()

    serial, st1 = run(1)
    piped, st2 = run(2)
    assert st1["pipeline_depth"] == 1 and st2["pipeline_depth"] == 2
    assert st2["dispatch_s"] > 0.0 and st2["fetch_s"] >= 0.0
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a.audio, b.audio)
        assert a.metrics == b.metrics


def test_stop_drains_inflight_groups():
    svc = service(max_batch=1, max_wait_ms=5, pipeline_depth=3)
    p = RenderParams(**BASE)
    futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(3)]
    svc.stop(timeout=300)
    for f in futs:
        assert np.isfinite(f.result(timeout=5).audio).all()
    assert svc._thread is None and svc._completer is None


def test_cancelled_and_live_jobs_in_one_group():
    """A group that mixes a cancelled job with live ones renders the live
    ones (the split goes by identity: items hold arrays and do not compare)."""
    svc = service(max_batch=4, max_wait_ms=20, start=False)
    p = RenderParams(**BASE)
    futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(3)]
    assert futs[1].cancel()
    svc.start()
    live = wait_all([futs[0], futs[2]])
    svc.stop()
    assert svc.stats()["batch_sizes"] == [2] and svc.stats()["inflight_input_bytes"] == 0
    np.testing.assert_allclose(live[1].audio, padded_reference(make_clip(2), p, 2), atol=TOL)


def test_pcm16_service_equals_the_quantized_float_service():
    p = RenderParams(**BASE)
    outs = {}
    for pcm16 in (False, True):
        svc = service(max_batch=2, max_wait_ms=20, pcm16_output=pcm16)
        try:
            outs[pcm16] = svc.render(RenderJob(make_clip(0), RATE, p, seed=1), timeout=300).audio
        finally:
            svc.stop()
    assert outs[True].dtype == np.int16
    want = wavio.encode_pcm16(np.clip(outs[False], -0.9999, 0.9999))
    np.testing.assert_array_equal(outs[True], want)


# ---------------------------------------------------------------- memory accounting


def test_result_owns_its_bytes():
    svc = service(max_batch=2, max_wait_ms=20)
    try:
        p = RenderParams(target_layout="Stereo")
        futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)]
        for r in wait_all(futs):
            assert r.audio.base is None and r.audio.flags.owndata
    finally:
        svc.stop()


def test_inflight_and_retained_accounting():
    svc = service(max_batch=2, max_wait_ms=20, start=False)
    try:
        p = RenderParams(target_layout="Stereo")
        futs = [svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)]
        st = svc.stats()
        # the clips as submitted (mono is duplicated only when a group is stacked)
        assert st["inflight_input_bytes"] == sum(make_clip(i).nbytes for i in range(2))
        assert st["retained_results"] == 0
        svc.start()
        results = wait_all(futs)
        st = svc.stats()
        assert st["inflight_input_bytes"] == 0 and st["retained_results"] == 2
        assert st["retained_result_bytes"] == sum(r.audio.nbytes for r in results)
        # the runtime's memory beside the process's; all zero on the CPU
        assert st["rss_mb"] > 0
        assert {k: st[k] for k in ("device_allocated_mb", "device_reserved_mb", "fft_plans",
                                   "fft_plans_max", "pinned_mb")} == dict.fromkeys(
            ("device_allocated_mb", "device_reserved_mb", "fft_plans", "fft_plans_max",
             "pinned_mb"), 0)
        assert "executables" not in st and "device_buffer_mb" not in st
        # copied up: the padded group at the bucket length; down: the real rows' buffer
        n_bucket = sharding.bucket_length(len(make_clip(0)), RATE)
        assert st["dispatched_input_bytes_total"] == 2 * n_bucket * 4
        assert st["fetched_result_bytes_total"] >= sum(r.audio.nbytes for r in results)
        del results, futs
        # the completer may still be returning from the group (its frame holds
        # the items, their futures, their results): stop() joins it first
        svc.stop()
        gc.collect()
        st = svc.stats()
        assert st["retained_results"] == 0 and st["retained_result_bytes"] == 0
    finally:
        svc.stop()


def test_cancelled_and_failed_jobs_release_inputs():
    svc = service(max_batch=8, max_wait_ms=50, start=False)
    p = RenderParams(target_layout="Stereo")
    try:
        fut = svc.submit(RenderJob(make_clip(0), RATE, p))
        assert svc.stats()["inflight_input_bytes"] > 0
        assert fut.cancel()
        svc.start()
        deadline = time.monotonic() + 30
        while svc.stats()["inflight_input_bytes"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc.stats()["inflight_input_bytes"] == 0
    finally:
        svc.stop()
    svc2 = service(max_batch=2, start=False)  # a stopped service flushing orphans
    fut = svc2.submit(RenderJob(make_clip(1), RATE, p))
    assert svc2.stats()["inflight_input_bytes"] > 0
    svc2.stop()
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)
    assert svc2.stats()["inflight_input_bytes"] == 0


def test_stats_keys_match_the_jax_service_but_for_the_runtime_fields():
    jax_svc = JaxService(max_batch=2, start=False)
    port_svc = service(max_batch=2, start=False)
    jax_keys, port_keys = set(jax_svc.stats()), set(port_svc.stats())
    jax_svc.stop()
    port_svc.stop()
    assert jax_keys - port_keys == {"executables", "device_buffer_mb"}
    assert port_keys - jax_keys == {"device_allocated_mb", "device_reserved_mb", "fft_plans",
                                    "fft_plans_max", "pinned_mb"}


# ---------------------------------------------------------------- render_batch(async_results)


@pytest.mark.parametrize("with_metrics", [False, True], ids=["plain", "metrics"])
@pytest.mark.parametrize("pcm16", [False, True], ids=["float32", "pcm16"])
def test_async_fetch_equals_the_synchronous_call(with_metrics, pcm16):
    clips = np.stack([np.pad(make_clip(i, seconds=0.2), (0, 800)) for i in range(3)])
    ps = [RenderParams(**BASE), RenderParams(bass_gain=1.5, **BASE),
          RenderParams(dry_wet=0.8, **BASE)]
    kw = dict(seeds=[4, 5, 6], with_metrics=with_metrics, pcm16_output=pcm16,
              clip_lengths=[3200, 3200, 4000], real_batch=2, device="cpu")
    want = sharding.render_batch(clips, RATE, ps, **kw)
    fetch = sharding.render_batch(clips, RATE, ps, async_results=True, **kw)
    assert callable(fetch)
    got = fetch()
    if with_metrics:
        assert got[1] == want[1] and len(got[1]) == 2
        got, want = got[0], want[0]
    assert got.shape[0] == 2 and got.shape[2] == 2  # pad row dropped, (B, len_out, channels)
    assert got.dtype == (np.int16 if pcm16 else np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_render_batch_takes_mono_stereo_and_wider_clips(channels):
    """Mono is duplicated, more than two channels cut to the first two —
    each equal to the solo render of the same clip."""
    rng = np.random.default_rng(channels)
    audio = (0.2 * rng.standard_normal((2, 3000, channels))).astype(np.float32)
    p = RenderParams(**BASE)
    out = sharding.render_batch(audio, RATE, p, seeds=[1, 2], device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(out[i], solo(audio[i], p, i + 1))


# ---------------------------------------------------------------- thread safety


def test_launch_counters_are_safe_under_threads():
    """More threads than cores with a short switch interval: a lost update
    would leave the count short."""
    before = bank.launch_count, bank.injected_launch_count
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def spin():
            for _ in range(2000):
                bank._count("launch_count")
                bank._count("injected_launch_count")

        threads = [threading.Thread(target=spin) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        got = bank.launch_count - before[0], bank.injected_launch_count - before[1]
        bank.launch_count, bank.injected_launch_count = before
    assert got == (32000, 32000)


def test_kernel_build_runs_once_for_threads_arriving_together(monkeypatch, tmp_path):
    """Eight threads reach the first-use build at once: one compiler run, and
    every thread gets the same library path."""
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.2)  # long enough for every thread to arrive
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")

        class Done:
            returncode, stdout, stderr = 0, "", ""

        return Done()

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_nvcc)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(kernels.build("rir_bank")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(runs) == 1 and len(set(paths)) == 1 and len(paths) == 8
    assert paths[0].exists()


def test_submits_from_many_threads_all_resolve():
    svc = service(max_batch=4, max_wait_ms=30, max_queued=64)
    p = RenderParams(**BASE)
    futs = {}

    def client(t):
        for k in range(3):
            i = 3 * t + k
            futs[i] = svc.submit(RenderJob(make_clip(i % 5, seconds=0.1), RATE, p, seed=i))

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        results = {i: f.result(timeout=300) for i, f in futs.items()}
    finally:
        svc.stop()
    st = svc.stats()
    assert st["jobs_done"] == 24 and sum(st["batch_sizes"]) == 24
    assert max(st["batch_sizes"]) <= 4 and st["inflight_input_bytes"] == 0
    for i in (0, 11, 23):
        want = padded_reference(make_clip(i % 5, seconds=0.1), p, i)
        np.testing.assert_allclose(results[i].audio, want, atol=TOL)


def test_memory_stats_on_the_cpu_reads_zero_runtime_fields():
    st = batcher.memory_stats("cpu")
    assert st["rss_mb"] > 0 and st["fft_plans"] == 0 and st["pinned_mb"] == 0


@pytest.mark.parametrize("dtype, kept", [(np.float32, True), (np.float64, False)])
def test_submit_keeps_a_view_of_a_float32_array(dtype, kept):
    """The contract in ``submit``'s doc string: a float32 array is kept, not
    copied, so a write before the future resolves changes the render; an
    array of another type is converted (copied) at submit."""
    p = RenderParams(**BASE)
    first, second = make_clip(1), make_clip(3)
    buf = first.astype(dtype)
    svc = service(max_batch=2, max_wait_ms=20, start=False)
    fut = svc.submit(RenderJob(buf, RATE, p, seed=4))
    buf[:] = second  # the caller reuses its buffer while the job is queued
    svc.start()
    try:
        out = fut.result(timeout=300).audio
    finally:
        svc.stop()
    rendered = second if kept else first
    np.testing.assert_allclose(out, padded_reference(rendered, p, 4), atol=TOL)
    other = padded_reference(first if kept else second, p, 4)
    assert np.abs(out - other).max() > 1e-2


def test_pipeline_depth_doc_counts_depth_plus_one_groups():
    """With depth 2 the worker dispatches a third group before it blocks on
    the completer's one-slot queue: depth + 1 groups hold buffers at once."""
    svc = service(max_batch=1, max_wait_ms=1, pipeline_depth=2, start=False)
    assert svc._cq.maxsize == svc.pipeline_depth - 1
    assert "depth + 1" in RenderService.__doc__
    p = RenderParams(**BASE)
    release, fetching = threading.Event(), threading.Event()
    dispatched = []
    real = svc._render_group

    def counting(items, stream=None):
        fetch, uploaded = real(items, stream)
        dispatched.append(len(items))

        def gated():
            fetching.set()
            release.wait(timeout=60)
            return fetch()
        return gated, uploaded

    svc._render_group = counting
    futs = [svc.submit(RenderJob(make_clip(i, seconds=0.1), RATE, p, seed=i)) for i in range(5)]
    svc.start()
    try:
        assert fetching.wait(timeout=60)
        deadline = time.time() + 30
        while len(dispatched) < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # a fourth dispatch would have come by now
        assert len(dispatched) == svc.pipeline_depth + 1
        release.set()
        wait_all(futs)
    finally:
        release.set()
        svc.stop()
    assert len(dispatched) == 5
