"""Checks that need an NVIDIA GPU and nvcc: the CUDA RIR-bank kernels (hash
and injected draws) against their plain PyTorch versions on the card, the
render paths through them, and the parity path at full size (BASELINE
configs 1-5, 60 s at 48 kHz) against the float64 oracle; the binaural mix
and ``resample_poly`` on the card against the CPU at 60 s; the serving
batcher's pipelined groups (one CUDA stream each, page-locked staging)
against direct ``render_batch`` calls, bit for bit; the visualizer's device
STFT against scipy at 60 s, ``process_audio_main_v41`` on the card against
the same call on the CPU, the ``compat`` chain at 60 s against its
float64 ``"oracle"`` arms; the streaming renderer at 5 minutes against the
single-shot render, and its exact-length filters against float64 cuFFT; the
device mesh on one card standing in for several shards (``ppermute`` across
the shards' streams, the data-parallel ``render_batch`` against the
meshless one, ``render_long`` against the single-shot render).

Marked ``cuda``; each test skips (with a reason) where no card is present,
as on a CPU-only machine.  This file imports no JAX (the oracle is NumPy and
SciPy only), so on the GPU machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 max-abs on the final IRs (peaks 0.9 / 0.7) — float
round-off of reductions summed in another order, and of expf/powf ulps;
bit-equal for the smoothed noise itself (the kernels stage it in shared
memory, the plain version re-hashes each tap: counter draws are order-free);
against the oracle, the parity contract (PARITY.md, tests/test_parity.py):
1e-3 max-abs, the PCM16 LSB rule, 0.01 LU, and 0.01 dB of peak and RMS.
"""

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu_torch import IRDraws, RenderParams
from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.ops import ir_synth
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.parallel import sharding

pytestmark = pytest.mark.cuda

BANK_TOL = 2e-5
ORACLE_TOL = 1e-3
LU_TOL = 0.01
DB_TOL = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("hall, room, rate", [
    ("Room", 100.0, 16000),
    ("Room", 100.0, 48000),
    ("Cathedral", 600.0, 48000),
    ("Plate", 10.0, 8000),
])
def test_bank_kernel_matches_plain(cuda, hall, room, rate):
    setup = pipeline.build_internal_setup(RenderParams(hall_type=hall, room_size=room), rate, 100)
    seeds = [0, 1, 7, 2**31, 0xFFFFFFFF]
    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).to(cuda)
    scal = setup.ir_scalars.table(len(seeds), cuda)
    before = bank.launch_count
    fin_k = bank._rir_block_cuda(seeds_t, scal, setup.ir_shape)
    fin_p = bank._rir_block_plain(seeds_t, scal, setup.ir_shape)
    torch.cuda.synchronize()
    assert bank.launch_count == before + 1  # one count per call, both passes
    for k, p in zip(fin_k, fin_p):
        assert k.shape == p.shape == (len(seeds), setup.ir_shape.length)
        assert (k - p).abs().max().item() <= BANK_TOL


def test_render_batch_launches_kernel_once(cuda):
    rate = 16000
    t = np.arange(rate // 2) / rate
    clips = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32)
                      for i in range(3)])
    p = RenderParams(target_layout="Stereo")
    for fast in (True, False):
        before = bank.launch_count
        out = sharding.render_batch(clips, rate, p, seeds=[1, 2, 2**31], fast_filters=fast,
                                    device=cuda)
        assert bank.launch_count == before + 1
        ref = sharding.render_batch(clips, rate, p, seeds=[1, 2, 2**31], fast_filters=fast,
                                    device="cpu")
        assert float(np.abs(out - ref).max()) <= 1e-4


def injected_inputs(shape, batch, seed, degenerate=()):
    """Seeded NumPy draws per entry in the injected bank's layout, on the card;
    entries in ``degenerate`` get ±1e-4 alternating noise (std(smoothed) ≤ 1e-6)."""
    rng = np.random.default_rng(seed)
    hi = max(2, shape.actual_max_early_delay)
    delays = rng.integers(1, hi, size=(batch, ir_synth.MAX_REFLECTIONS))
    strengths = rng.uniform(0.3, 0.8, size=(batch, ir_synth.MAX_REFLECTIONS))
    noise = rng.uniform(-1, 1, size=(batch, max(1, shape.late_length)))
    for b in degenerate:
        noise[b] = np.where(np.arange(noise.shape[1]) % 2 == 0, 1e-4, -1e-4)
    return [torch.from_numpy(a).cuda() for a in bank.pack_draws(shape, delays, strengths, noise)]


@pytest.mark.parametrize("name, params, rate, batch, degenerate", [
    ("bench", RenderParams(), 48000, 48, ()),
    ("cathedral", RenderParams(hall_type="Cathedral", room_size=600.0), 48000, 4, ()),
    ("degenerate", RenderParams(), 48000, 3, (1,)),
    ("plate", RenderParams(hall_type="Plate", room_size=10.0), 8000, 2, ()),
])
def test_injected_kernel_matches_plain(cuda, name, params, rate, batch, degenerate):
    setup = pipeline.build_internal_setup(params, rate, 100)
    shape = setup.ir_shape
    packed = injected_inputs(shape, batch, 3, degenerate)
    scal = setup.ir_scalars.table(batch, cuda)
    before = bank.injected_launch_count
    *fin_k, raw_k = bank._rir_bank_cuda(*packed, scal, shape)
    *fin_p, raw_p = bank._rir_bank_plain(*packed, scal, shape)
    torch.cuda.synchronize()
    assert bank.injected_launch_count == before + 1
    assert torch.equal(raw_k, raw_p)  # same fallback decisions
    assert raw_k.nonzero().flatten().tolist() == list(degenerate)
    for k, p in zip(fin_k, fin_p):
        assert (k - p).abs().max().item() <= BANK_TOL


def test_injected_kernel_split_point_one(cuda):
    """split_point 1, length 4096: the tail starts at sample 1 and its
    smoothing halo reaches past both tile edges."""
    from audio_raytracing_studio_tpu_torch.params import derive_ir_geometry

    g = derive_ir_geometry(16000, 4096 / 16000, 25, 0.06, "Holz", 0.5, 1.0 / 16000, 0.5)
    shape, sc = ir_synth.IRShape.from_geometry(g), ir_synth.IRScalars.from_geometry(g)
    assert shape.length == 4096 and shape.split_point == 1
    rng = np.random.default_rng(5)
    noise = rng.uniform(-1, 1, size=(2, shape.late_length))
    packed = [torch.from_numpy(a).cuda() for a in bank.pack_draws(
        shape, np.ones((2, 25), np.int32), np.full((2, 25), 0.5), noise)]
    scal = sc.table(2, cuda)
    fin_k = bank._rir_bank_cuda(*packed, scal, shape)
    fin_p = bank._rir_bank_plain(*packed, scal, shape)
    assert torch.equal(fin_k[2], fin_p[2])
    for k, p in zip(fin_k[:2], fin_p[:2]):
        assert (k - p).abs().max().item() <= BANK_TOL


def edge_shape(name):
    """(IRShape, IRScalars) of the shapes where the redesigned bank's
    indexing can go wrong."""
    room = pipeline.build_internal_setup(RenderParams(), 48000, 100)
    base = room.ir_shape
    shapes = {
        # the main path's shape: 72,000 samples, 18 tiles, rows 16-byte aligned
        "bench": base,
        # the tail starts at sample 1, length one whole tile
        "split1": ir_synth.IRShape(length=4096, split_point=1, actual_max_early_delay=1,
                                   reflection_count=25, late_length=4095,
                                   noise_smooth_width=10, early_taps_active=False),
        # L % 4 == 3: every row after the first starts off a 16-byte boundary
        "ragged": base._replace(length=2 * 4096 + 3, late_length=2 * 4096 + 3 - base.split_point),
        # Cathedral 600: 346,809 samples (odd), 85 tiles
        "cathedral": pipeline.build_internal_setup(
            RenderParams(hall_type="Cathedral", room_size=600.0), 48000, 100).ir_shape,
        # a last tile of 1 sample
        "tile_plus_one": base._replace(length=4 * 4096 + 1,
                                       late_length=4 * 4096 + 1 - base.split_point),
        # widths other than 10 take the kernels whose width is a run-time value
        "width8": base._replace(noise_smooth_width=8),
        "no_smoothing": base._replace(noise_smooth_width=1),
    }
    return shapes[name], room.ir_scalars


EDGE_CASES = [("bench", [0, 2**31, 0xFFFFFFFF]), ("split1", [5, 2**31 + 7]),
              ("ragged", [1, 2, 3, 0x80000001]), ("cathedral", [0xFFFFFFFF]),
              ("tile_plus_one", [9]), ("width8", [4, 2**31]), ("no_smoothing", [6])]


@pytest.mark.parametrize("name, seeds", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_bank_kernels_edge_shapes(cuda, name, seeds):
    """Both kernels against their plain versions at the edge shapes, B=1
    included (the parity path's batch), seeds ≥ 2^31 on the hash source."""
    shape, sc = edge_shape(name)
    batch = len(seeds)
    scal = sc.table(batch, cuda)
    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).to(cuda)
    for k, p in zip(bank._rir_block_cuda(seeds_t, scal, shape),
                    bank._rir_block_plain(seeds_t, scal, shape)):
        assert (k - p).abs().max().item() <= BANK_TOL, name
    packed = injected_inputs(shape, batch, 17)
    *fin_k, raw_k = bank._rir_bank_cuda(*packed, scal, shape)
    *fin_p, raw_p = bank._rir_bank_plain(*packed, scal, shape)
    assert torch.equal(raw_k, raw_p) and not raw_k.any()
    for k, p in zip(fin_k, fin_p):
        assert (k - p).abs().max().item() <= BANK_TOL, name


@pytest.mark.parametrize("name", ["bench", "split1", "ragged", "cathedral", "width8"])
def test_staged_smoothing_equals_rehashed_bit_for_bit(cuda, name):
    """The kernels smooth from noise staged once per index in shared memory;
    the plain version re-hashes each of the w taps.  With unit envelope and
    amplitude (log_decay 0, initial_amp 1) and the per-entry scales off, the
    late output IS the smoothed noise: it must agree bit for bit, for hash
    draws and for the same noise injected.  The plain version runs on the
    CPU, whose division by the width is exact (torch on CUDA multiplies by
    the reciprocal)."""
    shape, _ = edge_shape(name)
    seeds = [3, 2**31 + 1]
    scal = torch.tensor([[0.8, 0.5, 0.0, 1.0]] * 2, dtype=torch.float32)
    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds))
    early_k, late_k = bank._rir_block_cuda(seeds_t.to(cuda), scal.to(cuda), shape,
                                           unit_scales=True)
    early_p, late_p, _ = bank._hash_bank_raw(seeds_t, scal, shape)
    assert torch.equal(late_k.cpu(), late_p), name
    assert (early_k.cpu() - early_p).abs().max().item() <= 1e-6
    draws = [ir_synth.hash_draws(s, shape, cuda) for s in seeds]
    packed = [torch.stack([d[i] for d in draws]).contiguous() for i in range(3)]
    _, late_i, raw = bank._rir_bank_cuda(*packed, scal.to(cuda), shape, unit_scales=True)
    assert not raw.any()
    assert torch.equal(late_i.cpu(), late_p), name


def test_injected_kernel_degenerate_unit_scales(cuda):
    """A degenerate entry's raw-noise tail, before scaling, equals the plain
    version's raw tail bit for bit; the other entry keeps its smoothed tail."""
    shape, sc = edge_shape("bench")
    packed = injected_inputs(shape, 2, 23, degenerate=(0,))
    scal = sc.table(2, cuda)
    _, late_k, raw_k = bank._rir_bank_cuda(*packed, scal, shape, unit_scales=True)
    _, late_p, _, raw_tail = bank._injected_bank_raw(*packed, scal, shape)
    assert raw_k.tolist() == [True, False]
    # expf on both sides; 1e-10 and 1e-6 are a few ulps of tails peaking
    # near 3e-5 (±1e-4 noise) and 0.3
    assert (late_k[0] - raw_tail[0]).abs().max().item() <= 1e-10
    assert (late_k[1] - late_p[1]).abs().max().item() <= 1e-6


def test_render_draws_on_card_matches_cpu(cuda):
    rate = 16000
    t = np.arange(rate) / rate
    x = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    p = RenderParams(target_layout="5.1 (Standard)", hall_type="Cathedral", room_size=300.0)
    g = pipeline._internal_static(p, rate, 1, False)[0]
    d = IRDraws.sample(np.random.default_rng(9), g)
    before = bank.injected_launch_count
    out, metrics = pipeline.render(x, rate, p, draws=d, return_metrics=True, device=cuda)
    assert bank.injected_launch_count == before + 1
    ref, ref_metrics = pipeline.render(x, rate, p, draws=d, return_metrics=True, device="cpu")
    assert float(np.abs(out - ref).max()) <= 1e-4
    for key in ref_metrics:
        assert abs(metrics[key] - ref_metrics[key]) <= 0.01


def test_render_batch_metered_padded_on_card_matches_cpu(cuda):
    rate = 16000
    t = np.arange(rate // 2) / rate
    clips = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32)
                      for i in range(3)])
    lengths = [clips.shape[1], clips.shape[1] - 777, clips.shape[1] - 1234]
    for b, tl in enumerate(lengths):
        clips[b, tl:] = 0.0
    eq = RenderParams(target_layout="Stereo", bass_gain=1.6, treble_gain=0.7)
    params = [eq, eq, RenderParams(target_layout="Stereo")]
    kw = dict(seeds=[1, 2, 3], with_metrics=True, clip_lengths=lengths, pcm16_output=True)
    q, metrics = sharding.render_batch(clips, rate, params, device=cuda, **kw)
    q_ref, ref_metrics = sharding.render_batch(clips, rate, params, device="cpu", **kw)
    assert q.dtype == np.int16
    assert int(np.abs(q.astype(np.int32) - q_ref.astype(np.int32)).max()) <= 1
    for m, r in zip(metrics, ref_metrics):
        for key in r:
            assert abs(m[key] - r[key]) <= 0.01


# --- the parity path at full size against the float64 oracle ----------------

PARITY_RATE = 48000
PARITY_SECONDS = 60.0
_IR_RNG = np.random.default_rng(0x0C0FFEE)
_EXT_IR = (_IR_RNG.standard_normal((4800, 2))  # tests/test_parity.py's config-2 IR
           * np.exp(-np.arange(4800) / 800.0)[:, None] * 0.3).astype(np.float32)
_EXT_IR[0] = 1.0
_IR44 = (_IR_RNG.standard_normal((2205, 2)) * 0.2).astype(np.float32)
_CATHEDRAL = RenderParams(hall_type="Cathedral", room_size=600.0, air_absorption=0.5,
                          diffusion=0.8, target_layout="Stereo")
PARITY_CASES = {
    "config1_exact": (RenderParams(target_layout="Stereo"), False, None),
    "config1_fast": (RenderParams(target_layout="Stereo"), True, None),
    "config2_external": (RenderParams(use_external_ir=True, dry_wet=0.7,
                                      dry_wet_kill_start=0.4, bass_gain=1.6, treble_gain=0.6,
                                      target_layout="Stereo"), False, (_EXT_IR, None)),
    "config2_ir44k1": (RenderParams(use_external_ir=True, target_layout="Stereo"), False,
                       (_IR44, 44100)),
    "config3_exact": (_CATHEDRAL, False, None),
    "config3_fast": (_CATHEDRAL, True, None),
    "config4_51": (RenderParams(x_pos=0.2, y_pos=0.8, z_pos=0.3,
                                target_layout="5.1 (Standard)"), False, None),
    "config5_71": (RenderParams(target_layout="7.1 (Surround)", z_pos=0.7), False, None),
    "config5_512": (RenderParams(target_layout="5.1.2 (Atmos Light)", z_pos=0.7), False, None),
}


def parity_clips(n_clips=1):
    from audio_raytracing_studio_tpu_torch.tools.profile_render import bench_clips

    return bench_clips(n_clips, PARITY_SECONDS)


def assert_metrics_close(got, want):
    for key, tol in (("lufs", LU_TOL), ("true_peak_dbfs", DB_TOL), ("rms_dbfs", DB_TOL)):
        if float(got[key]) != float(want[key]):  # equal infinities pass
            assert abs(float(got[key]) - float(want[key])) <= tol, (key, got, want)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_parity_on_card_matches_oracle(cuda, case):
    """render(draws=... | external_ir=..., return_metrics=True) on the card
    at 60 s × 48 kHz against the oracle render and oracle meter; each render
    through draws launches the injected kernel once."""
    from scipy import signal

    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.oracle.loudness import calculate_audio_metrics

    p, fast, external = PARITY_CASES[case]
    mono = parity_clips()[0]
    before = bank.injected_launch_count
    if external is None:
        g = pipeline._internal_static(p, PARITY_RATE, 1, False)[0]
        draws = IRDraws.sample(np.random.default_rng(123), g)
        out, metrics = pipeline.render(mono, PARITY_RATE, p, draws=draws, fast_filters=fast,
                                       return_metrics=True, device=cuda)
        ref = dsp.render(mono, PARITY_RATE, p, draws=draws)
    else:
        ir, ir_rate = external
        out, metrics = pipeline.render(mono, PARITY_RATE, p, external_ir=ir,
                                       external_ir_rate=ir_rate, return_metrics=True,
                                       device=cuda)
        if ir_rate is not None:  # the oracle takes the IR at the render rate (scipy)
            ir = signal.resample(ir, int(len(ir) * PARITY_RATE / ir_rate),
                                 axis=0).astype(np.float32)
        ref = dsp.render(mono, PARITY_RATE, p, external_ir=ir)
    assert bank.injected_launch_count == before + (external is None)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert float(np.abs(out.astype(np.float64) - ref).max()) <= ORACLE_TOL
    lsb = int(np.abs(dsp.quantize_pcm16(out).astype(np.int32)
                     - dsp.quantize_pcm16(ref).astype(np.int32)).max())
    assert lsb <= max(1, int(np.ceil(ORACLE_TOL * 32768)))
    assert_metrics_close(metrics, calculate_audio_metrics(ref, PARITY_RATE))


@pytest.mark.parametrize("eq", [False, True], ids=["eq_off_fast", "eq_on_exact"])
def test_metered_padded_batch_matches_oracle_meter(cuda, eq):
    """render_batch(with_metrics, clip_lengths, pcm16) at B=48 × 60 s with
    mixed true lengths: the masked metrics of clips 0 and 47 against the
    oracle meter on their trimmed, dequantized output."""
    from audio_raytracing_studio_tpu.oracle.loudness import calculate_audio_metrics

    batch = 48
    clips = parity_clips(batch)
    n_in = clips.shape[1]
    lengths = [n_in - int(0.2 * n_in * b / (batch - 1)) for b in range(batch)]
    for b, tl in enumerate(lengths):
        clips[b, tl:] = 0.0
    p = (RenderParams(target_layout="Stereo", bass_gain=1.6, treble_gain=0.7) if eq
         else RenderParams(target_layout="Stereo"))
    q, metrics = sharding.render_batch(clips, PARITY_RATE, p, fast_filters=not eq,
                                       with_metrics=True, clip_lengths=lengths,
                                       pcm16_output=True, device=cuda)
    ir_len = q.shape[1] - n_in + 1
    for b in (0, batch - 1):
        vlen = lengths[b] + ir_len - 1
        assert not q[b, vlen:].any()
        trimmed = q[b, :vlen].astype(np.float64) / 32768.0
        assert_metrics_close(metrics[b], calculate_audio_metrics(trimmed, PARITY_RATE))


def test_binaural_on_card_matches_cpu(cuda):
    """60 s of 5.1 at 48 kHz (a 2^22-point transform): the card's table and
    mix against the CPU's, ≤ 1e-4 — cuFFT against pocketfft over 4 M points."""
    from audio_raytracing_studio_tpu_torch.ops import binaural

    x = (np.random.default_rng(6).standard_normal((60 * 48000, 6)) * 0.1).astype(np.float32)
    got = binaural.binauralize(x, 48000, "5.1 (Standard)", device=cuda)
    want = binaural.binauralize(x, 48000, "5.1 (Standard)", device="cpu")
    assert got.shape == want.shape == (60 * 48000, 2)
    assert float(np.abs(got - want).max()) <= 1e-4


def test_resample_poly_on_card_matches_cpu(cuda):
    """60 s of stereo, 44.1 → 48 kHz (160 phases, stride 147) through cuDNN
    with TF32 off, against the CPU, ≤ 1e-5 — with the caller's TF32 on, which
    resample_poly turns off for its convolution alone and gives back."""
    from audio_raytracing_studio_tpu_torch.ops.resample import resample_poly

    x = (np.random.default_rng(7).standard_normal((60 * 44100, 2)) * 0.2).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = resample_poly(torch.from_numpy(x).to(cuda), 48000, 44100)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = resample_poly(x, 48000, 44100)
    assert tuple(got.shape) == tuple(want.shape) == (60 * 48000, 2)
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def serving_clips(count, seconds, rate=48000):
    rng = np.random.default_rng(0x5E47)
    t = np.arange(int(seconds * rate)) / rate
    return [(0.3 * np.sin(2 * np.pi * (170.0 + 11.0 * i) * t)
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32) for i in range(count)]


def test_depth2_burst_equals_direct_render_batch(cuda):
    """16 jobs of 10 s at 48 kHz in groups of 8 at pipeline depth 2: each
    group renders on a stream of its own while the other's result comes
    down; every job equals its row of the direct call bit for bit, metrics
    included, and each group launched the bank once."""
    from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService

    rate = 48000
    clips = serving_clips(16, 10.0)
    params = [RenderParams(target_layout="Stereo", diffusion=0.2 + 0.04 * i, x_pos=i / 15.0)
              for i in range(16)]
    svc = RenderService(max_batch=8, max_wait_ms=2000, pcm16_output=True, pipeline_depth=2,
                        device=cuda, start=False)
    futs = [svc.submit(RenderJob(c, rate, p, seed=50 + i, with_metrics=True))
            for i, (c, p) in enumerate(zip(clips, params))]
    before = bank.launch_count
    svc.start()
    try:
        results = [f.result(timeout=300) for f in futs]
    finally:
        svc.stop()
    assert bank.launch_count == before + 2
    st = svc.stats()
    assert st["batch_sizes"] == [8, 8] and st["inflight_input_bytes"] == 0
    assert st["fft_plans"] > 0 and st["pinned_mb"] > 0 and st["device_reserved_mb"] > 0
    for g in range(2):
        rows = slice(8 * g, 8 * g + 8)
        direct, metrics = sharding.render_batch(
            np.stack(clips[rows]), rate, params[rows], seeds=range(50 + 8 * g, 58 + 8 * g),
            with_metrics=True, clip_lengths=[len(c) for c in clips[rows]], pcm16_output=True,
            device=cuda)
        for k, r in enumerate(results[rows]):
            assert r.audio.dtype == np.int16
            assert np.array_equal(r.audio, direct[k])
            assert r.metrics == metrics[k]


def test_pinned_staging_reuse_keeps_groups_apart(cuda):
    """Page-locked staging buffers go back to the host allocator and come
    out again while earlier copies may still be in flight.  Twelve distinct
    5 s clips in six groups of two at depth 2, then two asynchronous
    ``render_batch`` calls fetched in reverse order: a buffer reused before
    its copy had finished would give another group's audio, not an error."""
    from audio_raytracing_studio_tpu_torch.serving import RenderJob, RenderService

    rate = 48000
    clips = serving_clips(12, 5.0)
    p = RenderParams(target_layout="Stereo")
    svc = RenderService(max_batch=2, max_wait_ms=2000, pipeline_depth=2, max_queued=12,
                        device=cuda)
    try:
        results = [f.result(timeout=300) for f in
                   [svc.submit(RenderJob(c, rate, p, seed=i)) for i, c in enumerate(clips)]]
    finally:
        svc.stop()
    assert svc.stats()["batch_sizes"] == [2] * 6
    for g in range(6):
        direct = sharding.render_batch(np.stack(clips[2 * g: 2 * g + 2]), rate, p,
                                       seeds=[2 * g, 2 * g + 1], clip_lengths=[len(clips[0])] * 2,
                                       device=cuda)
        for k in range(2):
            assert np.array_equal(results[2 * g + k].audio, direct[k]), (g, k)

    staged = []
    for g in range(2):
        buf = sharding.staging_clips(2, len(clips[0]), 1, cuda)
        for k in range(2):
            buf[k] = clips[2 * g + k][:, None]
        staged.append(buf)
    fetches = [sharding.render_batch(buf, rate, p, seeds=[2 * g, 2 * g + 1], async_results=True,
                                     device=cuda) for g, buf in enumerate(staged)]
    for g in (1, 0):
        got = fetches[g]()
        want = sharding.render_batch(np.stack(clips[2 * g: 2 * g + 2]), rate, p,
                                     seeds=[2 * g, 2 * g + 1], device=cuda)
        assert np.array_equal(got, want), g


# --- the product surfaces on the card: the device STFT, the render API, compat ---

STFT_TOL = 1e-5  # of the power matrix's maximum (tests/test_torch_visualize.py's bound)


@pytest.fixture
def cuda_default(cuda):
    from audio_raytracing_studio_tpu_torch.utils import runtime

    previous = runtime.set_default_device("cuda")
    yield cuda
    runtime.set_default_device(previous)


def test_device_stft_on_card_matches_scipy_at_60s(cuda_default):
    from audio_raytracing_studio_tpu_torch.analysis import visualize

    x = parity_clips()[0]
    nperseg = visualize.spectrogram_nperseg(PARITY_SECONDS)
    f, t, sxx = visualize.compute_spectrogram(x, PARITY_RATE, nperseg, use_device=True)
    fs, ts, ss = visualize.compute_spectrogram(x, PARITY_RATE, nperseg)
    _, _, sc = visualize.compute_spectrogram(x, PARITY_RATE, nperseg, use_device=True,
                                             device="cpu")
    assert nperseg == 4096 and sxx.shape == ss.shape == (2049, (len(x) - 4096) // 2048 + 1)
    assert np.allclose(f, fs) and np.allclose(t, ts)
    top = float(ss.max())
    assert float(np.abs(sxx - ss).max()) / top <= STFT_TOL
    assert float(np.abs(sxx - sc).max()) / top <= STFT_TOL


@pytest.mark.parametrize("n", [4095, 777])
def test_device_stft_on_card_odd_one_frame(cuda, n):
    from audio_raytracing_studio_tpu_torch.analysis import visualize

    x = parity_clips()[0][:n]
    _, _, sxx = visualize.compute_spectrogram(x, PARITY_RATE, n, use_device=True, device=cuda)
    _, _, ss = visualize.compute_spectrogram(x, PARITY_RATE, n)
    assert sxx.shape == ss.shape == (n // 2 + 1, 1)
    assert float(np.abs(sxx - ss).max()) / float(ss.max()) <= STFT_TOL


def test_process_audio_main_on_card_matches_cpu_path(cuda_default, tmp_path):
    """The app's call on the card against the same call with the CPU as the
    process-wide device: PCM16 within 1 LSB, metrics within 0.01 LU / 0.1 dB
    as printed; one bank call."""
    import os
    import re

    from audio_raytracing_studio_tpu_torch import config
    from audio_raytracing_studio_tpu_torch.app import api
    from audio_raytracing_studio_tpu_torch.utils import runtime, wavio

    mono = parity_clips()[0]
    wavio.write(tmp_path / "in.wav", np.stack([mono, 0.7 * mono[::-1]], axis=1), PARITY_RATE)
    p = RenderParams(hall_type="Cathedral", room_size=300.0, target_layout="5.1 (Standard)",
                     bass_gain=1.6, treble_gain=0.7)
    args = [getattr(p, k) for k in config.PRESET_KEYS]
    before = bank.launch_count
    card = api.process_audio_main_v41(str(tmp_path / "in.wav"), None, None, *args, seed=2**32 - 1)
    assert bank.launch_count == before + 1
    runtime.set_default_device("cpu")
    cpu = api.process_audio_main_v41(str(tmp_path / "in.wav"), None, None, *args, seed=2**32 - 1)
    assert bank.launch_count == before + 1  # the CPU call took the plain version
    try:
        (a, ra), (b, rb) = wavio.read(card[0]), wavio.read(cpu[0])
        assert ra == rb == PARITY_RATE and a.shape == b.shape and a.shape[1] == 6
        assert np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max() <= 1
        na, nb = ([float(v) for v in re.findall(r"-?\d+\.\d+", s)] for s in (card[2], cpu[2]))
        assert abs(na[0] - nb[0]) <= LU_TOL + 1e-9 and max(abs(x - y) for x, y in zip(na, nb)) <= 0.1 + 1e-9
    finally:
        for res in (card, cpu):
            os.remove(res[0])


def test_compat_chain_on_card_matches_oracle_at_60s(cuda):
    """The reference's chain through the façade on the card against the same
    chain through its float64 ``"oracle"`` arms: ≤ 1e-3 at every stage."""
    from audio_raytracing_studio_tpu_torch import compat

    mono = parity_clips()[0]
    audio = np.stack([mono, 0.7 * mono[::-1]], axis=1)
    p = RenderParams(hall_type="Cathedral", room_size=300.0, air_absorption=0.3, bass_gain=1.6,
                     treble_gain=0.7, x_pos=0.3, y_pos=0.65, z_pos=0.45)
    dur, refs, maxd, split = compat.adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    direc = compat.compute_final_directionality_3d(p.x_pos, p.y_pos, p.z_pos, p.hall_type,
                                                   p.diffusion, p.dry_wet)
    el, ll = compat.adapt_early_late_levels(p.dry_wet, p.early_level, p.late_level)

    def chain(**kw):
        e, l = compat.generate_impulse_response_split_3d(
            PARITY_RATE, dur, refs, maxd, p.material, direc, split, p.diffusion, seed=5, **kw)
        mixed = compat.convolve_audio_split_3d(audio, e, l, el, ll, p.dry_wet, p.bass_gain,
                                               p.treble_gain, PARITY_RATE, p.dry_wet_kill_start,
                                               p.air_absorption, **kw)
        six = compat.apply_surround_panning_3d(mixed, p.x_pos, p.y_pos, p.z_pos, **kw)
        wide = compat.map_channels(six, "5.1.2 (Atmos Light)", PARITY_RATE, p.z_pos, **kw)[0]
        return e, l, mixed, six, wide, compat.calculate_audio_metrics(wide, PARITY_RATE, **kw)

    got, want = chain(device=cuda), chain(backend="oracle")
    for a, b in zip(got[:5], want[:5]):
        assert a.shape == b.shape
        assert float(np.abs(a.astype(np.float64) - b).max()) <= ORACLE_TOL
    assert_metrics_close(got[5], want[5])


def five_minute_clip(rate=48000):
    t = np.arange(5 * 60 * rate) / rate
    return (0.25 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * np.sin(2 * np.pi * 3.1 * t) * np.sin(2 * np.pi * 880.0 * t)).astype(np.float32)


@pytest.mark.parametrize("fast, eq, tol", [
    (False, False, 1e-4),  # the JAX test's bound (tests/test_streaming.py:254)
    (False, True, 1e-4),
    (True, False, 1e-3),  # fast against exact: the fast-air contract
])
def test_streaming_on_card_matches_single_shot_at_5min(cuda, fast, eq, tol):
    """``render_streaming`` on the card (30 s chunks, the bank at B=1) against
    the single-shot exact ``render`` of the same 5-minute clip, metrics
    included, and PCM16 on the card equal to ``wavio``'s."""
    from audio_raytracing_studio_tpu_torch.config import OUTPUT_CLIP
    from audio_raytracing_studio_tpu_torch.parallel.streaming import render_streaming
    from audio_raytracing_studio_tpu_torch.utils import wavio

    x = five_minute_clip()
    p = RenderParams(target_layout="5.1 (Standard)", room_size=200.0,
                     bass_gain=1.6 if eq else 1.0, treble_gain=0.7 if eq else 1.0)
    before = bank.launch_count
    out, m = render_streaming(x, 48000, p, seed=1, with_metrics=True, fast_filters=fast)
    q = render_streaming(x, 48000, p, seed=1, pcm16_output=True, fast_filters=fast)
    assert bank.launch_count == before + 2  # the CUDA bank, once per render
    ref, ref_m = pipeline.render(x, 48000, p, seed=1, return_metrics=True, device=cuda)
    assert out.shape == ref.shape and np.abs(out - ref).max() <= tol
    assert abs(m["lufs"] - ref_m["lufs"]) <= LU_TOL
    for k in ("true_peak_dbfs", "rms_dbfs"):
        assert abs(m[k] - ref_m[k]) <= DB_TOL
    assert np.array_equal(q, wavio.encode_pcm16(np.clip(out, -OUTPUT_CLIP, OUTPUT_CLIP)))


@pytest.mark.parametrize("n0", [14_400_911, 1 << 24])
def test_exact_length_filters_on_card_match_float64(cuda, n0):
    """The streaming EQ and air filters (Bluestein at m = 2^k) on the card
    against the same circular filters in float64 cuFFT: ≤ 1e-5 of the
    signal's maximum; positions past n0 zero."""
    from audio_raytracing_studio_tpu_torch.ops import filters
    from audio_raytracing_studio_tpu_torch.parallel import streaming_eq

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.zeros((3, n0 + 1000), device=cuda)
    x[:, :n0] = torch.randn((3, n0), device=cuda, generator=g)
    peak = x.abs().max().item()
    fac = torch.tensor([0.6], device=cuda)
    bg, tg = torch.tensor([1.6], device=cuda), torch.tensor([0.7], device=cuda)
    for got, gain in (
        (streaming_eq.shelf_eq_streaming(x, n0, 48000, bg, tg),
         filters.shelf_eq_gain(n0, 48000, bg, tg)[0]),
        (streaming_eq.air_absorption_streaming(x, n0, 48000, fac),
         filters.air_absorption_gain(n0, 48000, fac)[0]),
    ):
        ref = torch.fft.irfft(torch.fft.rfft(x[:, :n0].double(), n=n0) * gain.double(), n=n0)
        assert (got[:, :n0].double() - ref).abs().max().item() <= 1e-5 * peak
        assert not got[:, n0:].any()
    torch.backends.cuda.cufft_plan_cache.clear()


@pytest.mark.parametrize("n, rate", [(2_951_999, 48000), (3_155_898, 44100), (86_490_503, 48000)])
def test_gain_curves_on_card_equal_numpy_bit_for_bit(cuda, n, rate):
    """The filter curves built on the card in float64 carry the same bits as
    ``np.fft.rfftfreq``'s on the host."""
    from audio_raytracing_studio_tpu_torch import config
    from audio_raytracing_studio_tpu_torch.ops import filters

    freqs = np.fft.rfftfreq(n, d=1.0 / rate)
    start = config.AIR_ABSORPTION_START_HZ
    ramp = np.where(freqs >= start, np.clip((freqs - start) / (freqs[-1] - start), 0.0, 1.0), 0.0)
    bass, treble = filters._shelf_masks(n, rate, cuda)
    assert np.array_equal(filters._air_ramp(n, rate, cuda).cpu().numpy(), ramp.astype(np.float32))
    assert np.array_equal(bass.cpu().numpy(), (freqs > 1e-6) & (freqs <= config.EQ_BASS_CUTOFF_HZ))
    assert np.array_equal(treble.cpu().numpy(), freqs >= config.EQ_TREBLE_CUTOFF_HZ)


# --- the device mesh: one card standing in for several shards -----------------


def card_mesh(data=1, block=1):
    from audio_raytracing_studio_tpu_torch.parallel import mesh

    return mesh.make_mesh(data=data, block=block, devices=["cuda:0"] * (data * block))


def test_ppermute_on_one_card_copies_across_streams(cuda):
    """Two shards of one card hand tensors over by event, into fresh memory."""
    from audio_raytracing_studio_tpu_torch.parallel import mesh

    axis = card_mesh(block=4).axis("block")
    shards = axis.map(lambda k: torch.full((1 << 20,), float(k), device=cuda), range(4))
    out = mesh.ppermute(axis, shards, mesh.ring(axis))
    axis.map(lambda s: s.fill_(-1.0), shards)  # later writes on the senders' streams
    torch.cuda.synchronize()
    for k in range(4):
        assert out[k].data_ptr() != shards[(k - 1) % 4].data_ptr()
        assert torch.equal(out[k], torch.full((1 << 20,), float((k - 1) % 4), device=cuda))
    total = mesh.psum(axis, [s + 2.0 for s in shards])
    torch.cuda.synchronize()
    assert all(torch.equal(t, torch.full((1 << 20,), 4.0, device=cuda)) for t in total)


def test_mesh_render_batch_on_card_equals_meshless(cuda):
    """data=4 on one card, with metrics, PCM16 and padded EQ-on clips:
    PCM16 within 1 LSB of the meshless render (a shard's cuFFT plans are
    made for B/4 rows), metrics within 1e-5."""
    rate = 48000
    t = np.arange(rate * 2) / rate
    clips = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32)
                      for i in range(8)])
    lens = [clips.shape[1] - 997 * (i % 3) for i in range(8)]
    for b, n in enumerate(lens):
        clips[b, n:] = 0.0
    p = RenderParams(target_layout="Stereo", bass_gain=1.6, treble_gain=0.7)
    kw = dict(seeds=range(8), with_metrics=True, pcm16_output=True, clip_lengths=lens,
              device="cuda")
    before = bank.launch_count
    q, metrics = sharding.render_batch(clips, rate, p, device_mesh=card_mesh(4), **kw)
    assert bank.launch_count == before + 4  # the bank once per shard
    want, want_metrics = sharding.render_batch(clips, rate, p, **kw)
    assert np.abs(q.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for g, w in zip(metrics, want_metrics):
        assert all(abs(g[k] - w[k]) <= 1e-5 for k in g)


def test_render_long_on_card_matches_single_shot(cuda):
    from audio_raytracing_studio_tpu_torch.parallel import long_render

    rate = 48000
    rng = np.random.default_rng(3)
    t = np.arange(rate * 5) / rate
    x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    p = RenderParams(target_layout="7.1 (Surround)", room_size=120.0, bass_gain=1.6,
                     treble_gain=0.7)
    out, metrics = long_render.render_long(x, rate, p, card_mesh(block=4), seed=3,
                                           with_metrics=True)
    exact, solo = pipeline.render(x, rate, p, seed=3, fast_filters=False, return_metrics=True,
                                  device="cuda")
    assert out.shape == exact.shape
    assert np.abs(out - exact).max() <= ORACLE_TOL
    assert abs(metrics["lufs"] - solo["lufs"]) <= 0.02


# --- the back half: csrc/back_half.cu against its plain version ---------------

BACK_HALF_LAYOUTS = ("Stereo", "5.1 (Standard)", "7.1 (Surround)", "5.1.2 (Atmos Light)")


def back_half_inputs(batch: int, n_in: int, n: int, seed: int, cuda):
    """(dry (B, 2, n_in), wet (B, 2, n), MixScalars) on the card, one clip
    per path through the kernels' passes: 0 loud (the first two
    normalizations scale: positions at the corner where the front-left gain
    is 1.075), 1 quiet (no normalization scales), 2 below 1e-9 (zeroed),
    3 the pan alone over 1 (wet only, peak 0.97, corner), 4 the Stereo map
    alone over 1 (wet only, equal channels, peak 0.95, centre), the rest
    drawn at random; a smaller batch keeps its first clips."""
    from audio_raytracing_studio_tpu_torch.models.pipeline import MixScalars

    r = np.random.default_rng(seed)
    dry = r.uniform(-1.0, 1.0, (batch, 2, n_in)).astype(np.float32)
    wet = r.uniform(-1.0, 1.0, (batch, 2, n)).astype(np.float32)
    cols = {f: r.uniform(0.0, 1.0, batch).astype(np.float32) for f in MixScalars._fields}
    for b, level in ((0, 3.0), (1, 0.2), (2, 1e-11))[:batch]:
        dry[b] *= level
        wet[b] *= level
    if batch > 4:
        wet[3] *= 0.97 / np.abs(wet[3]).max()
        wet[4, 1] = wet[4, 0] = wet[4, 0] * (0.95 / np.abs(wet[4, 0]).max())
        cols["dry_wet"][3:5] = 1.0  # the mix is the wet signal, bit for bit
    for b, pos in ((0, 0.0), (3, 0.0), (4, 0.5))[:batch]:
        for f in ("x_pos", "y_pos", "z_pos"):
            cols[f][b] = pos
    scal = MixScalars(*(torch.from_numpy(cols[f]).to(cuda) for f in MixScalars._fields))
    return torch.from_numpy(dry).to(cuda), torch.from_numpy(wet).to(cuda), scal


def assert_bit_equal(got, want):
    """torch.equal on the bit patterns, with NaN where the plain version has
    NaN (torch.equal alone reads NaN as unequal to itself)."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0.0).view(torch.int32),
                       want.masked_fill(nan, 0.0).view(torch.int32))
    if not nan.any():
        assert torch.equal(got, want)


def back_half_pair(dry, wet, scal, layout, eq, rate=48000):
    from audio_raytracing_studio_tpu_torch.ops import back_half_cuda

    before = back_half_cuda.launch_count
    got = back_half_cuda.back_half(dry, wet, scal, layout, rate, eq)
    want = back_half_cuda.back_half_plain(dry, wet, scal, layout, rate, eq)
    torch.cuda.synchronize()
    assert back_half_cuda.launch_count == before + 1
    return got, want


@pytest.mark.parametrize("batch, n_in, n", [
    (5, 1, 1),            # one sample: every delayed sample is a zero
    (6, 300, 577),        # shorter than the 12 / 18 ms delays at 48 kHz
    (5, 2048, 4097),      # one past a block's span
    (7, 4095, 12289),     # odd, across three spans
], ids=["n1", "n577", "n4097", "n12289"])
@pytest.mark.parametrize("eq_on", [False, True], ids=["eq-off", "eq-on"])
@pytest.mark.parametrize("layout", BACK_HALF_LAYOUTS)
def test_back_half_kernel_matches_plain(cuda, layout, eq_on, batch, n_in, n):
    from audio_raytracing_studio_tpu_torch.ops import filters

    dry, wet, scal = back_half_inputs(batch, n_in, n, seed=n + batch, cuda=cuda)

    def eq(mixed):
        return filters.apply_shelf_eq(mixed, 48000, scal.bass_gain, scal.treble_gain)

    got, want = back_half_pair(dry, wet, scal, layout, eq if eq_on else None)
    assert_bit_equal(got, want)
    assert not got[2].any()
    if not eq_on:
        assert float(got[:2].abs().max()) <= 1.0


@pytest.mark.parametrize("layout", BACK_HALF_LAYOUTS)
def test_back_half_kernel_non_finite_clips(cuda, layout):
    """A NaN passes its clip unscaled (NaN > 1 is false); an inf scales its
    clip by 0 (inf·0 is NaN); the other clips are untouched by either."""
    dry, wet, scal = back_half_inputs(6, 3000, 3500, seed=9, cuda=cuda)
    wet[1, 0, 1234] = float("nan")
    dry[3, 1, 17] = float("inf")
    wet[5, 1, 3499] = -float("inf")
    got, want = back_half_pair(dry, wet, scal, layout, None)
    assert_bit_equal(got, want)
    assert torch.isnan(got[1]).any() and torch.isfinite(got[0]).all()


@pytest.mark.parametrize("layout, batch, n_in, n, eq_on", [
    ("Stereo", 48, 2_880_000, 2_951_999, False),                 # room-stereo.batch48
    ("Stereo", 1, 2_880_000, 2_951_999, False),                  # render(): one clip
    ("5.1 (Standard)", 48, 2_880_000, 3_155_898, True),          # the padded cell's shape
], ids=["batch48", "b1", "padded-5.1-eq"])
def test_back_half_kernel_main_shapes(cuda, layout, batch, n_in, n, eq_on):
    from audio_raytracing_studio_tpu_torch.ops import filters

    dry, wet, scal = back_half_inputs(batch, n_in, n, seed=batch, cuda=cuda)

    def eq(mixed):
        return filters.apply_shelf_eq(mixed, 48000, scal.bass_gain, scal.treble_gain)

    got, want = back_half_pair(dry, wet, scal, layout, eq if eq_on else None)
    assert_bit_equal(got, want)


def test_back_half_counted_once_per_padded_render_batch(cuda):
    """The padded, EQ-on path of render_batch (its EQ between the kernels'
    mix and their passes): one count per call, the render equal to the
    CPU's within the card-vs-CPU tolerance."""
    from audio_raytracing_studio_tpu_torch.ops import back_half_cuda

    rate = 16000
    t = np.arange(rate) / rate
    clips = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32)
                      for i in range(3)])
    lens = [rate, rate - 997, rate - 4001]
    for b, n in enumerate(lens):
        clips[b, n:] = 0.0
    p = RenderParams(hall_type="Cathedral", room_size=300.0, target_layout="5.1 (Standard)",
                     bass_gain=1.6, treble_gain=0.7)
    kw = dict(seeds=[1, 2, 3], with_metrics=True, clip_lengths=lens)
    for _ in range(2):
        before = back_half_cuda.launch_count
        out, _ = sharding.render_batch(clips, rate, p, device=cuda, **kw)
        assert back_half_cuda.launch_count == before + 1
    ref, _ = sharding.render_batch(clips, rate, p, device="cpu", **kw)
    assert float(np.abs(out - ref).max()) <= 1e-4


@pytest.mark.parametrize("layout", BACK_HALF_LAYOUTS)
def test_back_half_kernel_positions_across_and_off_the_square(cuda, layout):
    """Positions across and off the unit square reach the kernels through
    their coefficient table: 256 clips with x swept across [-0.1, 1.1], y
    and z drawn over [-0.2, 1.2], then the corners, the centre and a NaN
    position, all bit-equal to the plain version."""
    batch, n = 256, 97
    dry, wet, scal = back_half_inputs(batch, 61, n, seed=3, cuda=cuda)
    r = np.random.default_rng(4)
    x = np.linspace(-0.1, 1.1, batch).astype(np.float32)
    y, z = r.uniform(-0.2, 1.2, (2, batch)).astype(np.float32)
    fixed = [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (1.0, 0.0, 0.5),
             (0.0, 1.0, -3.0), (-1.0, 2.0, 0.25), (float("nan"), 0.5, 0.5)]
    for b, pos in enumerate(fixed, start=5):
        x[b], y[b], z[b] = pos
    scal = scal._replace(x_pos=torch.from_numpy(x).to(cuda), y_pos=torch.from_numpy(y).to(cuda),
                         z_pos=torch.from_numpy(z).to(cuda))
    got, want = back_half_pair(dry, wet, scal, layout, None)
    assert_bit_equal(got, want)
    assert torch.isnan(got[11]).any() and torch.isfinite(got[:11]).all()
