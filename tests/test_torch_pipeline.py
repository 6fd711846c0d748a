"""The port's render path (models/pipeline.py, parallel/sharding.py and the ops
under them) against the JAX package and the float64 oracle, on the CPU.

Tolerances:
- port vs JAX, same seed or same draws: ≤ 1e-4 max-abs on the rendered
  output — two float32 FFT libraries (pocketfft in torch, ducc in XLA) and
  the JAX package's Bluestein / affine-wrap forms of the exact-length
  filters; measured margins are ~1e-6 (CHANGES.md);
- port vs oracle (injected IRDraws): ≤ 1e-3 max-abs plus the PCM16 LSB rule
  of tests/test_parity.py — the product's parity contract;
- filters and spatial units vs JAX: ≤ 1e-5 (one transform pair, no
  convolution gain);
- metrics vs JAX and vs the oracle meter: ≤ 0.01 LU (PARITY.md item 2),
  sample peak and RMS ≤ 1e-3 dB;
- PCM16 quantization: bit-equal.

Parameters and draws are the port's own classes; ``jx`` carries them across
to the JAX package's (same fields) where a JAX or oracle function computes
the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.metering import loudness as jloud
from audio_raytracing_studio_tpu.models import pipeline as jpipe
from audio_raytracing_studio_tpu.ops import filters as jfilters
from audio_raytracing_studio_tpu.ops import spatial as jspatial
from audio_raytracing_studio_tpu.oracle import dsp
from audio_raytracing_studio_tpu.oracle.loudness import calculate_audio_metrics
from audio_raytracing_studio_tpu import params as jparams
from audio_raytracing_studio_tpu.parallel import sharding as jsharding
from audio_raytracing_studio_tpu_torch import IRDraws, RenderParams
from audio_raytracing_studio_tpu_torch.models import convert
from audio_raytracing_studio_tpu_torch.models import pipeline as tpipe
from audio_raytracing_studio_tpu_torch.ops import convolution, filters, spatial
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.parallel import sharding as tsharding

torch.set_num_threads(1)

JAX_TOL = 1e-4
ORACLE_TOL = 1e-3
UNIT_TOL = 1e-5
LU_TOL = 0.01
DB_TOL = 1e-3


def tone(rate: int, seconds: float, seed: int = 3) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3150.0 * t)
         + 0.05 * r.standard_normal(t.shape))
    x[: rate // 100] = 0.0
    x[len(x) // 2] = 0.9
    return x.astype(np.float32)


def jx(obj):
    """The port's RenderParams / IRDraws (or a list of RenderParams) → the
    JAX package's class with the same fields."""
    if isinstance(obj, (list, tuple)):
        return [jx(o) for o in obj]
    cls = {RenderParams: jparams.RenderParams, IRDraws: jparams.IRDraws}[type(obj)]
    return cls(**dataclasses.asdict(obj))


def max_err(a, b) -> float:
    assert a.shape == b.shape, f"{a.shape} vs {b.shape}"
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# --- render: port vs JAX, same seed ---------------------------------------

RENDER_CASES = {
    "stereo_fast_48k": (48000, 1.2, RenderParams(target_layout="Stereo"), True),
    "stereo_exact_48k": (48000, 1.2, RenderParams(target_layout="Stereo"), False),
    "51_exact": (16000, 1.0, RenderParams(target_layout="5.1 (Standard)", x_pos=0.2,
                                          y_pos=0.8, z_pos=0.3), False),
    "71_exact": (16000, 1.0, RenderParams(target_layout="7.1 (Surround)", z_pos=0.7), False),
    "512_exact": (16000, 1.0, RenderParams(target_layout="5.1.2 (Atmos Light)", z_pos=0.7),
                  False),
    "eq_exact": (16000, 1.0, RenderParams(target_layout="Stereo", bass_gain=1.6,
                                          treble_gain=0.6, dry_wet=0.7,
                                          dry_wet_kill_start=0.4), False),
    # len_out ≥ 2^17 and not a power of two: JAX's affine-wrap air path
    "cathedral_exact_wrap": (16000, 1.2, RenderParams(target_layout="Stereo",
                                                      hall_type="Cathedral", room_size=600.0,
                                                      air_absorption=0.5, diffusion=0.8),
                             False),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax_same_seed(case):
    rate, seconds, p, fast = RENDER_CASES[case]
    x = tone(rate, seconds)
    want = jpipe.render(x, rate, jx(p), seed=11, fast_filters=fast)
    got = tpipe.render(x, rate, p, seed=11, fast_filters=fast, device="cpu")
    assert got.dtype == np.float32
    if case == "cathedral_exact_wrap":
        assert got.shape[0] >= 1 << 17 and got.shape[0] & (got.shape[0] - 1)
    assert max_err(got, want) <= JAX_TOL


# --- render(draws=...) vs the oracle: tests/test_parity.py's BASELINE configs

BASELINE = {
    "config1_room_stereo": RenderParams(target_layout="Stereo"),
    # config 2 (external IR) is test_config2_external_ir_matches_oracle below
    "config3_cathedral_air": RenderParams(hall_type="Cathedral", room_size=600.0,
                                          air_absorption=0.5, diffusion=0.8,
                                          target_layout="Stereo"),
    "config4_51_positioned": RenderParams(x_pos=0.2, y_pos=0.8, z_pos=0.3,
                                          target_layout="5.1 (Standard)"),
    "config5_71": RenderParams(target_layout="7.1 (Surround)", z_pos=0.7),
    "config5_512": RenderParams(target_layout="5.1.2 (Atmos Light)", z_pos=0.7),
}


def oracle_draws(p: RenderParams, rate: int, seed=123) -> IRDraws:
    setup = tpipe._internal_static(p, rate, 1, False)[0]
    return IRDraws.sample(np.random.default_rng(seed), setup)


ORACLE_CASES = [(c, False) for c in sorted(BASELINE)] + [
    ("config1_room_stereo", True),  # fast mode on the configs with air absorption
    ("config3_cathedral_air", True),
]


@pytest.mark.parametrize("config, fast", ORACLE_CASES)
def test_render_draws_matches_oracle(tone48k, config, fast):
    x, rate = tone48k
    p = BASELINE[config]
    d = oracle_draws(p, rate)
    got = tpipe.render(x, rate, p, draws=d, fast_filters=fast, device="cpu")
    ref = dsp.render(x, rate, jx(p), draws=jx(d))
    assert max_err(got, ref) <= ORACLE_TOL
    q_got, q_ref = dsp.quantize_pcm16(got), dsp.quantize_pcm16(ref)
    lsb = int(np.max(np.abs(q_got.astype(np.int32) - q_ref.astype(np.int32))))
    assert lsb <= max(1, int(np.ceil(ORACLE_TOL * 32768)))


def test_render_draws_matches_jax_draws(tone48k):
    x, rate = tone48k
    p = BASELINE["config4_51_positioned"]
    d = oracle_draws(p, rate)
    assert max_err(tpipe.render(x, rate, p, draws=d, device="cpu"),
                   jpipe.render(x, rate, jx(p), draws=jx(d))) <= JAX_TOL


def assert_metrics_close(got: dict, want: dict, lu=LU_TOL, db=DB_TOL):
    assert set(got) >= {"lufs", "true_peak_dbfs", "rms_dbfs"}
    for key, tol in (("lufs", lu), ("true_peak_dbfs", db), ("rms_dbfs", db)):
        g, w = float(got[key]), float(want[key])
        assert (g == w) if np.isinf(w) else abs(g - w) <= tol, (key, g, w)


# --- external-IR mode: BASELINE config 2 -------------------------------------

CONFIG2 = RenderParams(use_external_ir=True, dry_wet=0.7, dry_wet_kill_start=0.4,
                       bass_gain=1.6, treble_gain=0.6, target_layout="Stereo")


def external_ir(rng, n_ir=4800):
    """tests/test_parity.py's config-2 IR: decaying noise, a unit first tap."""
    env = np.exp(-np.arange(n_ir) / 800.0)[:, None]
    ir = (rng.standard_normal((n_ir, 2)) * env * 0.3).astype(np.float32)
    ir[0] = 1.0
    return ir


def assert_oracle_parity(got, ref):
    assert max_err(got, ref) <= ORACLE_TOL
    q_got, q_ref = dsp.quantize_pcm16(got), dsp.quantize_pcm16(ref)
    lsb = int(np.max(np.abs(q_got.astype(np.int32) - q_ref.astype(np.int32))))
    assert lsb <= max(1, int(np.ceil(ORACLE_TOL * 32768)))


def test_config2_external_ir_matches_oracle(rng, tone48k):
    x, rate = tone48k
    ir = external_ir(rng)
    got, metrics = tpipe.render(x, rate, CONFIG2, external_ir=ir, return_metrics=True,
                                device="cpu")
    ref = dsp.render(x, rate, jx(CONFIG2), external_ir=ir)
    assert got.shape == ref.shape == (x.shape[0] + ir.shape[0] - 1, 2)
    assert_oracle_parity(got, ref)
    assert_metrics_close(metrics, calculate_audio_metrics(ref, rate))
    want = jpipe.render(x, rate, jx(CONFIG2), external_ir=ir)
    assert max_err(got, want) <= JAX_TOL


def test_external_ir_resampled_44k1(rng, tone48k):
    """A 44.1 kHz IR is Fourier-resampled to 48 kHz; the oracle gets the
    scipy-resampled IR (tests/test_parity.py::test_external_ir_resampled)."""
    from scipy import signal

    x, rate = tone48k
    ir44 = (rng.standard_normal((2205, 2)) * 0.2).astype(np.float32)
    ir48 = tpipe.prepare_external_ir(ir44, 44100, rate).numpy()
    assert ir48.shape == (2400, 2)
    assert max_err(ir48, signal.resample(ir44, 2400, axis=0)) <= 5e-6
    p = RenderParams(use_external_ir=True, target_layout="Stereo")
    got = tpipe.render(x, rate, p, external_ir=ir44, external_ir_rate=44100, device="cpu")
    assert_oracle_parity(got, dsp.render(x, rate, jx(p), external_ir=ir48))
    want = jpipe.render(x, rate, jx(p), external_ir=ir44, external_ir_rate=44100)
    assert max_err(got, want) <= JAX_TOL


@pytest.mark.parametrize("ir, match", [
    (np.zeros((100, 1), np.float32), "stereo"),
    (np.zeros((100, 3), np.float32), "stereo"),
    (np.zeros(100, np.float32), "2-D"),
    (np.zeros((0, 2), np.float32), "empty"),
])
def test_external_ir_rejections(ir, match):
    x = tone(8000, 0.2)
    p = RenderParams(use_external_ir=True)
    with pytest.raises(ValueError, match=match):
        tpipe.render(x, 8000, p, external_ir=ir, device="cpu")
    # a non-stereo IR is rejected before any resample
    with pytest.raises(ValueError, match=match):
        tpipe.prepare_external_ir(ir, 44100, 8000)
    with pytest.raises(ValueError, match="requires external_ir"):
        tpipe.render(x, 8000, p, device="cpu")


# --- metrics: render(return_metrics=True) -----------------------------------

METRIC_CASES = {
    "stereo_seed": (RenderParams(target_layout="Stereo"), 48000),
    "51_seed": (RenderParams(target_layout="5.1 (Standard)", x_pos=0.2, y_pos=0.8), 16000),
    "71_eq": (RenderParams(target_layout="7.1 (Surround)", bass_gain=1.6, treble_gain=0.7),
              16000),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_render_metrics_match_jax_and_oracle(case):
    p, rate = METRIC_CASES[case]
    x = tone(rate, 1.2)
    got, metrics = tpipe.render(x, rate, p, seed=5, return_metrics=True, device="cpu")
    want, want_metrics = jpipe.render(x, rate, jx(p), seed=5, return_metrics=True)
    assert max_err(got, want) <= JAX_TOL
    assert_metrics_close(metrics, want_metrics)
    assert_metrics_close(metrics, calculate_audio_metrics(got, rate))
    assert np.array_equal(tpipe.render(x, rate, p, seed=5, device="cpu"), got)


def test_render_metrics_silent_input():
    x = np.zeros(8000, np.float32)
    out, metrics = tpipe.render(x, 8000, RenderParams(target_layout="Stereo"), seed=1,
                                return_metrics=True, device="cpu")
    assert not out.any()
    assert metrics == {"lufs": -np.inf, "true_peak_dbfs": -np.inf, "rms_dbfs": -np.inf}


def test_injected_draws_over_budget_rejected(rng):
    from audio_raytracing_studio_tpu_torch.params import derive_ir_geometry

    g = derive_ir_geometry(8000, 0.5, 200, 0.06, "Holz", 0.5, 0.03, 0.5)
    with pytest.raises(ValueError, match="MAX_REFLECTIONS"):
        convert.draws_from_numpy(IRDraws.sample(rng, g))


def test_render_deterministic_and_seed_sensitive():
    x = tone(8000, 0.3)
    p = RenderParams(target_layout="Stereo")
    a = tpipe.render(x, 8000, p, seed=42, device="cpu")
    assert np.array_equal(a, tpipe.render(x, 8000, p, seed=42, device="cpu"))
    assert not np.array_equal(a, tpipe.render(x, 8000, p, seed=43, device="cpu"))
    # seeds wrap to 32 bits, as in the JAX package
    assert np.array_equal(tpipe.render(x, 8000, p, seed=2**32 + 42, device="cpu"), a)


# --- render_batch: port vs JAX (Pallas bank backend) -------------------------

SWEEP = [
    RenderParams(target_layout="Stereo", air_absorption=0.005, x_pos=0.2, dry_wet=0.3),
    RenderParams(target_layout="Stereo", air_absorption=0.3, x_pos=0.5, bass_gain=1.5),
    RenderParams(target_layout="Stereo", air_absorption=0.8, x_pos=0.9, dry_wet=0.9,
                 late_level=1.4),
]
SWEEP_SEEDS = [1, 2**31, 0xFFFFFFFF]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_render_batch_matches_jax_pallas(fast):
    rate = 16000
    clips = np.stack([tone(rate, 0.5, seed=i) for i in range(3)])
    want = jsharding.render_batch(clips, rate, jx(SWEEP), seeds=SWEEP_SEEDS,
                                  ir_backend="pallas", fast_filters=fast)
    before = bank.launch_count
    got = tsharding.render_batch(clips, rate, SWEEP, seeds=SWEEP_SEEDS, fast_filters=fast,
                                 device="cpu")
    assert bank.launch_count == before
    assert got.dtype == np.float32
    assert max_err(got, want) <= JAX_TOL
    # the plain per-clip IR path renders the same audio
    alt = tsharding.render_batch(clips, rate, SWEEP, seeds=SWEEP_SEEDS, fast_filters=fast,
                                 ir_backend="jnp", device="cpu")
    assert max_err(alt, got) <= JAX_TOL


def test_render_batch_clip_matches_single_render():
    """Per-clip normalization: a clip renders the same alone or in a batch."""
    rate = 8000
    clips = np.stack([tone(rate, 0.4, seed=i) * (1 + 3 * i) for i in range(3)])
    p = RenderParams(target_layout="5.1 (Standard)")
    out = tsharding.render_batch(clips, rate, p, seeds=[4, 5, 6], device="cpu")
    for i in range(3):
        solo = tpipe.render(clips[i], rate, p, seed=4 + i, device="cpu")
        assert max_err(out[i], solo) <= 1e-6


def test_render_batch_pcm16_and_real_batch():
    rate = 8000
    clips = np.stack([tone(rate, 0.3, seed=i) for i in range(4)])
    p = RenderParams(target_layout="Stereo")
    f = tsharding.render_batch(clips, rate, p, device="cpu")
    q = tsharding.render_batch(clips, rate, p, pcm16_output=True, real_batch=3, device="cpu")
    assert q.dtype == np.int16 and q.shape == (3,) + f.shape[1:]
    np.testing.assert_array_equal(q, dsp.quantize_pcm16(f[:3]))
    with pytest.raises(ValueError, match="real_batch"):
        tsharding.render_batch(clips, rate, p, real_batch=5, device="cpu")


class TestRenderBatchContract:
    rate = 8000

    def clips(self, b=2):
        return np.stack([tone(self.rate, 0.25, seed=i) for i in range(b)])

    def test_shape_mismatch_names_geometry(self):
        ps = [RenderParams(target_layout="Stereo"),
              RenderParams(target_layout="Stereo", z_pos=0.9)]  # same length, other taps
        with pytest.raises(ValueError, match="IR geometry"):
            tsharding.render_batch(self.clips(), self.rate, ps, device="cpu")

    def test_layout_mismatch_names_spec(self):
        ps = [RenderParams(target_layout="Stereo"), RenderParams()]
        with pytest.raises(ValueError, match="spec"):
            tsharding.render_batch(self.clips(), self.rate, ps, device="cpu")

    def test_stage_flags_widen_across_sweep(self):
        """A clip with EQ/air/early off shares a batch with one that has them on."""
        ps = [RenderParams(target_layout="Stereo", air_absorption=0.0, early_level=0.0),
              RenderParams(target_layout="Stereo", bass_gain=2.0)]
        out = tsharding.render_batch(self.clips(), self.rate, ps, seeds=[8, 9], device="cpu")
        for i, p in enumerate(ps):
            solo = tpipe.render(self.clips()[i], self.rate, p, seed=8 + i, device="cpu")
            assert max_err(out[i], solo) <= 1e-6

    @pytest.mark.parametrize("kwargs, exc", [
        # a device_mesh that is no parallel.mesh.Mesh (the id dates from
        # when every mesh was refused)
        pytest.param({"device_mesh": object()}, TypeError, id="kwargs0-NotImplementedError"),
        ({"real_batch": 0}, ValueError),
        ({"ir_backend": "pallas"}, ValueError),
        ({"seeds": [1, 2, 3]}, ValueError),
        ({"clip_lengths": [1]}, ValueError),
    ])
    def test_rejected_options(self, kwargs, exc):
        with pytest.raises(exc):
            tsharding.render_batch(self.clips(), self.rate, RenderParams(), device="cpu",
                                   **kwargs)


# --- render_batch: metrics, padded EQ, external IR ---------------------------

def padded_clips(rate, seconds, cuts):
    """Clips zero-padded to one bucket: clip b's true length is N − cuts[b]."""
    clips = np.stack([tone(rate, seconds, seed=i) for i in range(len(cuts))])
    lengths = [clips.shape[1] - c for c in cuts]
    for b, tl in enumerate(lengths):
        clips[b, tl:] = 0.0  # bucket padding is zeros by contract
    return clips, lengths


PADDED_PARAMS = [
    RenderParams(target_layout="Stereo", room_size=50.0, bass_gain=2.0, treble_gain=0.4),
    RenderParams(target_layout="Stereo", room_size=50.0, bass_gain=2.0, treble_gain=0.4),
    RenderParams(target_layout="Stereo", room_size=50.0),
]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_render_batch_metrics_match_jax(fast):
    """with_metrics + clip_lengths (masked meter) + padded EQ-on clips + PCM16,
    against the JAX package's render_batch on the same seeds."""
    rate = 16000
    clips, lengths = padded_clips(rate, 0.8, [0, 777, 1234])
    kw = dict(seeds=[0, 1, 2], clip_lengths=lengths, with_metrics=True, fast_filters=fast)
    got, metrics = tsharding.render_batch(clips, rate, PADDED_PARAMS, device="cpu", **kw)
    want, want_metrics = jsharding.render_batch(clips, rate, jx(PADDED_PARAMS), **kw)
    assert max_err(got, want) <= JAX_TOL
    assert len(metrics) == 3
    for m, w in zip(metrics, want_metrics):
        assert_metrics_close(m, w)
    q, q_metrics = tsharding.render_batch(clips, rate, PADDED_PARAMS, device="cpu",
                                          pcm16_output=True, real_batch=2, **kw)
    assert q.dtype == np.int16 and q.shape == (2,) + got.shape[1:]
    np.testing.assert_array_equal(q, dsp.quantize_pcm16(got[:2]))
    assert q_metrics == metrics[:2]


def test_padded_eq_clip_matches_unpadded_solo():
    """Analogue of tests/test_parallel.py::test_padded_eq_clip_matches_unpadded_solo:
    every clip of a padded batch — padded or not, EQ on or off — matches its
    unpadded solo render, is zero past its true span, and meters the same."""
    rate = 16000
    clips, lengths = padded_clips(rate, 0.5, [0, 777, 1234])
    out, metrics = tsharding.render_batch(clips, rate, PADDED_PARAMS, seeds=[0, 1, 2],
                                          clip_lengths=lengths, with_metrics=True,
                                          device="cpu")
    for b, (tl, p) in enumerate(zip(lengths, PADDED_PARAMS)):
        solo, solo_metrics = tpipe.render(clips[b, :tl], rate, p, seed=b,
                                          return_metrics=True, device="cpu")
        assert max_err(out[b, : solo.shape[0]], solo) <= 2e-5, f"clip {b}"
        assert not out[b, solo.shape[0]:].any()
        assert_metrics_close(metrics[b], solo_metrics)


def test_padded_eq_matches_oracle():
    """The true-length EQ of a padded clip against the float64 oracle
    (tests/test_parity.py::TestDynamicEQOracleParity, one length)."""
    from audio_raytracing_studio_tpu.ops import ir_synth as jir

    rate, n0, bucket = 8000, 5123, 8000
    p = RenderParams(target_layout="Stereo", room_size=60.0, bass_gain=1.7, treble_gain=0.5)
    x = tone(rate, n0 / rate)
    padded = np.zeros((1, bucket), np.float32)
    padded[0, :n0] = x
    out = tsharding.render_batch(padded, rate, [p], seeds=[11], clip_lengths=[n0],
                                 device="cpu")[0]
    g = tpipe._internal_static(p, rate, 1, False)[0]
    d, st, nz = map(np.asarray, jir.hash_draws(11, jir.IRShape.from_geometry(g)))
    draws = IRDraws(delays=d[: g.reflection_count], strengths=st[: g.reflection_count],
                    noise=nz[: g.late_length])
    ref = dsp.render(x, rate, jx(p), draws=jx(draws))
    assert_oracle_parity(out[: ref.shape[0]], ref)
    assert not out[ref.shape[0]:].any()


def test_render_batch_metrics_unpadded_match_solo():
    rate = 8000
    clips = np.stack([tone(rate, 1.0, seed=i) * (0.5 + i) for i in range(3)])
    p = RenderParams(target_layout="5.1 (Standard)")
    out, metrics = tsharding.render_batch(clips, rate, p, seeds=[3, 4, 5], with_metrics=True,
                                          device="cpu")
    for i in range(3):
        solo, m = tpipe.render(clips[i], rate, p, seed=3 + i, return_metrics=True,
                               device="cpu")
        assert max_err(out[i], solo) <= 1e-6
        assert_metrics_close(metrics[i], m, lu=1e-4, db=1e-4)
        assert_metrics_close(metrics[i], calculate_audio_metrics(solo, rate))


class TestBatchedExternal:
    rate = 16000

    def clips(self, b):
        t = np.arange(self.rate // 2) / self.rate
        return np.stack([(0.4 * np.sin(2 * np.pi * (220 + 60 * i) * t)).astype(np.float32)
                         for i in range(b)])

    def test_external_batch_matches_single_and_jax(self, rng):
        ir = (rng.standard_normal((800, 2)) * 0.2).astype(np.float32)
        params = [RenderParams(use_external_ir=True, target_layout="Stereo", dry_wet=dw)
                  for dw in (0.3, 0.6, 0.9)]
        clips = self.clips(3)
        out, metrics = tsharding.render_batch(clips, self.rate, params, external_ir=ir,
                                              with_metrics=True, device="cpu")
        assert out.shape == (3, clips.shape[1] + 800 - 1, 2) and len(metrics) == 3
        want, want_metrics = jsharding.render_batch(clips, self.rate, jx(params), external_ir=ir,
                                                    with_metrics=True)
        assert max_err(out, want) <= JAX_TOL
        for i, p in enumerate(params):
            single = tpipe.render(clips[i], self.rate, p, external_ir=ir, device="cpu")
            assert max_err(out[i], single) <= 2e-5
            assert_metrics_close(metrics[i], want_metrics[i])

    def test_external_pcm16_and_masked_metrics(self, rng):
        """Analogue of tests/test_parallel.py::test_external_pcm16_and_masked_metrics."""
        clips = self.clips(2)
        true_lens = [clips.shape[1], int(0.3 * self.rate)]
        clips[1, true_lens[1]:] = 0.0
        ir = (rng.standard_normal((800, 2)) * 0.2).astype(np.float32)
        p = RenderParams(use_external_ir=True, target_layout="Stereo", dry_wet=0.6)
        f = tsharding.render_batch(clips, self.rate, p, external_ir=ir, device="cpu")
        q, metrics = tsharding.render_batch(clips, self.rate, p, external_ir=ir,
                                            with_metrics=True, pcm16_output=True,
                                            clip_lengths=true_lens, device="cpu")
        assert q.dtype == np.int16
        np.testing.assert_array_equal(q, dsp.quantize_pcm16(f))
        real_len = true_lens[1] + ir.shape[0] - 1
        ref = jloud.audio_metrics(jnp.asarray(f[1, :real_len].T), self.rate)
        assert_metrics_close(metrics[1], {k: float(v) for k, v in ref.items()})
        _, want = jsharding.render_batch(clips, self.rate, jx(p), external_ir=ir,
                                         with_metrics=True, pcm16_output=True,
                                         clip_lengths=true_lens)
        for m, w in zip(metrics, want):
            assert_metrics_close(m, w)

    def test_external_padded_eq_and_resampled_ir(self, rng):
        """Padded EQ-on clips on the external path, with a 44.1 kHz IR."""
        clips = self.clips(2)
        true_lens = [clips.shape[1], clips.shape[1] - 999]
        clips[1, true_lens[1]:] = 0.0
        ir = (rng.standard_normal((441, 2)) * 0.2).astype(np.float32)
        p = RenderParams(use_external_ir=True, target_layout="5.1 (Standard)",
                         bass_gain=1.8, treble_gain=0.5)
        out = tsharding.render_batch(clips, self.rate, p, external_ir=ir,
                                     external_ir_rate=44100, clip_lengths=true_lens,
                                     device="cpu")
        want = jsharding.render_batch(clips, self.rate, jx(p), external_ir=ir,
                                      external_ir_rate=44100, clip_lengths=true_lens)
        assert max_err(out, want) <= JAX_TOL
        solo = tpipe.render(clips[1, : true_lens[1]], self.rate, p, external_ir=ir,
                            external_ir_rate=44100, device="cpu")
        assert max_err(out[1, : solo.shape[0]], solo) <= 2e-5

    @pytest.mark.parametrize("params, ir, match", [
        ([RenderParams(use_external_ir=True), RenderParams()], np.zeros((10, 2)), "mixed"),
        ([RenderParams(use_external_ir=True)] * 2, None, "requires external_ir"),
        ([RenderParams(use_external_ir=True, target_layout="Stereo"),
          RenderParams(use_external_ir=True, target_layout="5.1 (Standard)")],
         np.zeros((10, 2)), "target_layout"),
        ([RenderParams(use_external_ir=True)] * 2, np.zeros((10, 1)), "stereo"),
    ], ids=["mixed_modes", "missing_ir", "mixed_layouts", "mono_ir"])
    def test_external_batch_rejections(self, params, ir, match):
        with pytest.raises(ValueError, match=match):
            tsharding.render_batch(np.zeros((2, 1000), np.float32), self.rate, params,
                                   external_ir=ir, device="cpu")


# --- host setup carried across --------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("p", [
    RenderParams(),
    RenderParams(hall_type="Cathedral", room_size=600.0, air_absorption=0.5, diffusion=0.8),
    RenderParams(hall_type="Plate", room_size=10.0, bass_gain=1.6, dry_wet=0.95,
                 early_level=0.0, air_absorption=0.0, target_layout="7.1 (Surround)"),
], ids=["room", "cathedral", "plate_edge"])
def test_build_internal_setup_matches_from_jax_setup(p, fast):
    ours = tpipe.build_internal_setup(p, 48000, 12345, fast_filters=fast)
    theirs = convert.from_jax_setup(jpipe.build_internal_setup(jx(p), 48000, 12345,
                                                                fast_filters=fast))
    assert ours.ir_shape == theirs.ir_shape
    assert ours.spec == theirs.spec
    for a, b in zip(ours.ir_scalars + ours.mix_scalars, theirs.ir_scalars + theirs.mix_scalars):
        assert np.float32(a).tobytes() == np.float32(b).tobytes()
    assert tpipe.build_internal_spec(p, 48000, 12345, fast) == (ours.spec, ours.ir_shape)


# --- units -----------------------------------------------------------------

def test_quantize_pcm16_bit_equal():
    x = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, np.nan, np.inf, -np.inf,
                  0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 0.9999, -0.99995], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).uniform(-1.2, 1.2, 5000).astype(np.float32)])
    got = tpipe.quantize_pcm16(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.asarray(jpipe.quantize_pcm16(jnp.asarray(x))))
    np.testing.assert_array_equal(got, dsp.quantize_pcm16(x))


def test_conditional_peak_normalize_is_per_clip():
    r = np.random.default_rng(1)
    x = np.stack([3.0 * r.standard_normal((2, 500)), 0.2 * r.uniform(-1, 1, (2, 500)),
                  1e-12 * np.ones((2, 500))]).astype(np.float32)
    got = filters.conditional_peak_normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.vmap(jfilters.conditional_peak_normalize)(jnp.asarray(x)))
    np.testing.assert_array_equal(got[1], x[1])  # the quiet clip is untouched
    assert not got[2].any()
    assert max_err(got, want) <= 1e-7


@pytest.mark.parametrize("n", [4096, 5003, 131101])  # pow2, Bluestein, affine wrap in JAX
def test_exact_length_filters_match_jax(n):
    rate = 16000
    x = np.random.default_rng(n).standard_normal((2, 2, n)).astype(np.float32)
    air = np.array([0.3, 0.9], np.float32)
    bass, treble = np.array([1.6, 0.4], np.float32), np.array([0.6, 3.0], np.float32)
    got_air = filters.apply_air_absorption(torch.from_numpy(x), rate, torch.from_numpy(air))
    got_eq = filters.apply_shelf_eq(torch.from_numpy(x), rate, torch.from_numpy(bass),
                                    torch.from_numpy(treble))
    for b in range(2):
        want_air = jfilters.apply_air_absorption(jnp.asarray(x[b]), rate, air[b])
        want_eq = jfilters.apply_shelf_eq(jnp.asarray(x[b]), rate, bass[b], treble[b])
        assert max_err(got_air[b].numpy(), want_air) <= UNIT_TOL
        assert max_err(got_eq[b].numpy(), want_eq) <= UNIT_TOL


def test_fast_fft_length_rule():
    for n in (1, 2, 3, 5, 1000, 4097, 6145, 2951999):
        m = convolution.fast_fft_length(n)
        assert m >= n
        assert m in {1 << k for k in range(24)} | {3 << k for k in range(23)}
    assert convolution.fast_fft_length(2951999) == 3 * 2**20


def test_convolutions_match_direct_float64():
    r = np.random.default_rng(5)
    sig = r.standard_normal((2, 2, 300)).astype(np.float32)
    ker = r.standard_normal((2, 2, 77)).astype(np.float32)
    w = np.array([[0.8, 0.6], [1.2, 0.1]], np.float32)
    out_len = 300 + 77 - 1
    full = convolution.convolve_full(torch.from_numpy(sig), torch.from_numpy(ker), out_len)
    comb = convolution.convolve_combined(torch.from_numpy(sig), torch.from_numpy(ker),
                                         torch.from_numpy(w), out_len)
    assert full.shape == (2, 2, 2, out_len) and comb.shape == (2, 2, out_len)
    for b in range(2):
        for c in range(2):
            direct = [np.convolve(sig[b, c].astype(np.float64), ker[b, k]) for k in range(2)]
            for k in range(2):
                assert max_err(full[b, k, c].numpy(), direct[k]) <= 1e-4
            assert max_err(comb[b, c].numpy(), w[b, 0] * direct[0] + w[b, 1] * direct[1]) <= 1e-4


def test_pan_and_layouts_match_jax():
    r = np.random.default_rng(2)
    pos = r.uniform(-0.2, 1.2, size=(3, 4)).astype(np.float32)
    got = spatial.pan_matrix(*map(torch.from_numpy, pos[:3]))
    want = np.stack([np.asarray(jspatial.pan_matrix(*pos[:3, b])) for b in range(4)])
    assert max_err(got.numpy(), want) <= 1e-6
    audio = r.standard_normal((4, 2, 700)).astype(np.float32)
    six = spatial.apply_pan(torch.from_numpy(audio), got)
    six_j = np.stack([np.asarray(jspatial.apply_pan(jnp.asarray(audio[b]), want[b]))
                      for b in range(4)])
    assert max_err(six.numpy(), six_j) <= UNIT_TOL
    for layout in ("Stereo", "5.1 (Standard)", "7.1 (Surround)", "5.1.2 (Atmos Light)", "x"):
        out = spatial.map_layout(six, layout, 16000, torch.from_numpy(pos[2]))
        out_j = np.stack([np.asarray(jspatial.map_layout(jnp.asarray(six_j[b]), layout, 16000,
                                                         pos[2, b])) for b in range(4)])
        assert max_err(out.numpy(), out_j) <= UNIT_TOL
        assert spatial.layout_channel_names(layout) == jspatial.layout_channel_names(layout)
        assert out.shape[1] == len(spatial.layout_channel_names(layout))
