"""The port's streaming renderer (parallel/streaming.py, parallel/streaming_eq.py)
against the JAX package's, on the CPU.

Each case feeds the same seeded numpy inputs to both packages' functions
(the port with ``device="cpu"``) and mirrors a case of
``tests/test_streaming.py`` or ``tests/test_streaming_eq.py``.

Tolerances:
- port against JAX: ≤ 2e-5 max-abs where the JAX side runs plain FFTs (fast
  filters, EQ off); ≤ 5e-5 where it runs its four-step Bluestein (EQ on, or
  exact air), that transform's own bound (tests/test_streaming_eq.py);
- metrics: ≤ 0.01 LU and ≤ 0.01 dB (PARITY.md item 2);
- chunk invariance: ≤ 1e-5 (overlap-add is exact; float32 round-off);
- the port's streaming render against its single-shot render: ≤ 1e-4 with
  exact filters (the JAX test's bound), ≤ 1e-3 fast against exact (the
  fast-air contract);
- PCM16: bit-equal to quantizing the float result on the host, within 1 LSB
  of the JAX package's.

Every clip is 16 kHz and 2 s long, through one short hall, so that every
render runs several chunks and the JAX side compiles each pass once per
mode and layout.  The gaps are
recorded with ``record_property``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.parallel import streaming as jstreaming
from audio_raytracing_studio_tpu.parallel import streaming_eq as jstreaming_eq
from audio_raytracing_studio_tpu.params import RenderParams as JaxParams
from audio_raytracing_studio_tpu_torch import RenderParams, config
from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.ops import filters
from audio_raytracing_studio_tpu_torch.parallel import streaming, streaming_eq
from audio_raytracing_studio_tpu_torch.utils import wavio

torch.set_num_threads(1)

RATE = 16000
SECONDS = 2.0
CHUNK_S = 0.4
FFT_TOL = 2e-5
BLUESTEIN_TOL = 5e-5
INVARIANCE_TOL = 1e-5
LU_TOL = 0.01
DB_TOL = 0.01
# a 6,400-sample IR: chunks are at least 2·l = 12,800 samples (0.8 s), so a
# 2 s clip (len_out 38,399) runs through three of them
HALL = dict(hall_type="Plate", room_size=10.0)


def clip(seed: int, stereo: bool = False, seconds: float = SECONDS) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * RATE)) / RATE
    x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * r.standard_normal(len(t))).astype(np.float32)
    if stereo:
        return np.stack([x, 0.8 * np.roll(x, 37)], axis=1)
    return x


def external_ir(taps: int = 700) -> np.ndarray:
    return (np.random.default_rng(5).standard_normal((taps, 2)) * 0.2).astype(np.float32)


# name → (params, render_streaming kwargs, stereo input, the JAX side runs its Bluestein)
CASES = {
    "fast_stereo_mono_in_metrics": (
        dict(target_layout="Stereo", air_absorption=0.6, **HALL),
        dict(with_metrics=True), False, False),
    "exact_stereo_stereo_in": (
        dict(target_layout="Stereo", air_absorption=0.7, **HALL),
        dict(fast_filters=False), True, True),
    "exact_eq_51_metrics": (
        dict(target_layout="5.1 (Standard)", air_absorption=0.6, bass_gain=1.6,
             treble_gain=0.7, z_pos=0.4, **HALL),
        dict(fast_filters=False, with_metrics=True), False, True),
    "fast_eq_stereo": (
        dict(target_layout="Stereo", bass_gain=2.0, treble_gain=0.6, **HALL),
        dict(), True, True),
    "fast_71_metrics": (
        # 7.1's 12 ms side delay spills past len_out in the padded buffer
        dict(target_layout="7.1 (Surround)", air_absorption=0.0, z_pos=0.6, **HALL),
        dict(with_metrics=True), True, False),
    "external_ir_metrics": (
        # with metrics the 0.4 s chunk (6,400) is raised to the meter's FIR
        dict(use_external_ir=True, target_layout="Stereo", dry_wet=0.7),
        dict(with_metrics=True), True, False),
}


def run_case(name, package, **extra):
    params, kwargs, stereo, _ = CASES[name]
    x = clip(3, stereo)
    kwargs = dict(kwargs, seed=3, chunk_seconds=CHUNK_S, **extra)
    if params.get("use_external_ir"):
        kwargs["external_ir"] = external_ir()
    if package == "jax":
        return jstreaming.render_streaming(x, RATE, JaxParams(**params), **kwargs)
    return streaming.render_streaming(x, RATE, RenderParams(**params), device="cpu", **kwargs)


_JAX_RESULTS = {}


def jax_result(name):
    """The JAX package's render of a case, computed once per module."""
    if name not in _JAX_RESULTS:
        _JAX_RESULTS[name] = run_case(name, "jax")
    return _JAX_RESULTS[name]


def split(result, with_metrics):
    out, metrics = result if with_metrics else (result, None)
    return np.asarray(out), metrics


def metric_gaps(got: dict, want: dict) -> list:
    assert set(got) == set(want) == {"lufs", "true_peak_dbfs", "rms_dbfs"}
    gaps = []
    for k in ("lufs", "true_peak_dbfs", "rms_dbfs"):
        g, w = float(got[k]), float(want[k])
        gaps.append(0.0 if g == w else abs(g - w))
    return gaps


@pytest.mark.parametrize("name", list(CASES))
def test_render_streaming_matches_jax(name, record_property):
    params, kwargs, stereo, bluestein = CASES[name]
    with_metrics = kwargs.get("with_metrics", False)
    got, got_m = split(run_case(name, "torch"), with_metrics)
    want, want_m = split(jax_result(name), with_metrics)
    assert got.dtype == np.float32 and got.shape == want.shape
    gap = float(np.abs(got - want).max())
    record_property("max_abs_vs_jax", gap)
    assert gap <= (BLUESTEIN_TOL if bluestein else FFT_TOL)
    if with_metrics:
        gaps = metric_gaps(got_m, want_m)
        record_property("metric_gaps_vs_jax", gaps)
        assert gaps[0] <= LU_TOL and max(gaps[1:]) <= DB_TOL


@pytest.mark.parametrize("name, fast, tol", [
    ("exact_stereo_stereo_in", False, 1e-4),
    ("exact_eq_51_metrics", False, 1e-4),
    ("fast_stereo_mono_in_metrics", True, 1e-3),
    ("external_ir_metrics", True, 1e-4),
])
def test_streaming_matches_single_shot(name, fast, tol, record_property):
    """The port's streaming render against its own single-shot exact render
    of the same clip (fast filters within the 1e-3 fast-air contract), and
    the streamed metrics against the single-shot meter."""
    params, kwargs, stereo, _ = CASES[name]
    x = clip(3, stereo)
    ir = external_ir() if params.get("use_external_ir") else None
    got, got_m = split(run_case(name, "torch", with_metrics=True), True)
    single, single_m = pipeline.render(x, RATE, RenderParams(**params), seed=3, external_ir=ir,
                                       return_metrics=True, fast_filters=False, device="cpu")
    assert got.shape == single.shape
    gap = float(np.abs(got - single).max())
    record_property("max_abs_vs_single_shot", gap)
    assert gap <= tol
    gaps = metric_gaps(got_m, single_m)
    record_property("metric_gaps_vs_single_shot", gaps)
    assert gaps[0] <= LU_TOL and max(gaps[1:]) <= DB_TOL


@pytest.mark.parametrize("fast_filters, params", [
    (True, dict(target_layout="Stereo", air_absorption=0.5, **HALL)),
    (False, dict(target_layout="Stereo", air_absorption=0.5, **HALL)),
    (True, dict(target_layout="5.1 (Standard)", bass_gain=1.6, treble_gain=0.7, **HALL)),
])
def test_chunk_size_invariance(fast_filters, params, record_property):
    """Three chunks of 12,800 samples against two of 24,000: the same render."""
    x = clip(1)
    p = RenderParams(**params)
    a = streaming.render_streaming(x, RATE, p, seed=1, chunk_seconds=0.3,
                                   fast_filters=fast_filters, device="cpu")
    b = streaming.render_streaming(x, RATE, p, seed=1, chunk_seconds=1.5,
                                   fast_filters=fast_filters, device="cpu")
    gap = float(np.abs(a - b).max())
    record_property("max_abs_chunk_0.3_vs_1.5", gap)
    assert 0.0 < gap <= INVARIANCE_TOL  # two different chunkings, one result


def test_pcm16_output_bit_identical_and_within_one_lsb_of_jax(record_property):
    name = "exact_eq_51_metrics"
    out_f, m_f = run_case(name, "torch")
    out_q, m_q = run_case(name, "torch", pcm16_output=True)
    assert out_q.dtype == np.int16 and out_q.shape == out_f.shape
    host = wavio.encode_pcm16(np.clip(out_f, -config.OUTPUT_CLIP, config.OUTPUT_CLIP))
    assert np.array_equal(out_q, host)
    assert m_q == m_f  # metrics measure the float signal
    want = wavio.encode_pcm16(np.clip(np.asarray(jax_result(name)[0]), -config.OUTPUT_CLIP,
                                      config.OUTPUT_CLIP))
    lsb = int(np.abs(out_q.astype(np.int32) - want.astype(np.int32)).max())
    record_property("pcm16_lsb_vs_jax", lsb)
    assert lsb <= 1


def test_cases_run_several_chunks():
    """The cases above exercise the carried tails: each runs ≥ 3 chunks."""
    for name, (params, kwargs, _, _) in CASES.items():
        x = clip(3)
        ir = external_ir() if params.get("use_external_ir") else None
        plan = streaming._plan(x[:, None], RATE, RenderParams(**params), 3, CHUNK_S,
                               kwargs.get("with_metrics", False), ir, None,
                               kwargs.get("fast_filters", True), torch.device("cpu"))
        assert plan.n_chunks >= 3, (name, plan.chunk, plan.n_chunks)


def test_metrics_only_mode():
    name = "fast_stereo_mono_in_metrics"
    _, m_full = run_case(name, "torch")
    none, m_only = run_case(name, "torch", return_output=False)
    assert none is None and m_only == m_full
    for package in (jstreaming, streaming):
        with pytest.raises(ValueError, match="return_output=False requires with_metrics=True"):
            package.render_streaming(clip(0), RATE, RenderParams(), return_output=False)


def test_silence_meters_minus_infinity():
    x = np.zeros(int(SECONDS * RATE), np.float32)
    p = dict(target_layout="Stereo", **HALL)
    out, got = streaming.render_streaming(x, RATE, RenderParams(**p), chunk_seconds=CHUNK_S,
                                          with_metrics=True, device="cpu")
    _, want = jstreaming.render_streaming(x, RATE, JaxParams(**p), chunk_seconds=CHUNK_S,
                                          with_metrics=True)
    assert not out.any()
    assert got == want == {k: float("-inf") for k in ("lufs", "true_peak_dbfs", "rms_dbfs")}


@pytest.mark.parametrize("bad", [float("inf"), float("nan"), 0.0, -1.0])
def test_nonfinite_chunk_seconds_is_a_valueerror(bad):
    x = clip(0, seconds=0.2)
    for package, params in ((streaming, RenderParams()), (jstreaming, JaxParams())):
        with pytest.raises(ValueError, match="chunk_seconds must be a positive finite number"):
            package.render_streaming(x, RATE, params, chunk_seconds=bad)


def test_no_card_raises_instead_of_running_on_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.render_streaming(clip(0, seconds=0.2), RATE, RenderParams())
    from audio_raytracing_studio_tpu_torch.tools import bench_long

    assert bench_long.main(["--minutes", "0.01"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().out


# ------------------------------------------------------- streaming_eq

# (n0, n_total, rate): tests/test_streaming_eq.py's lengths — a prime (odd)
# n0 exactly filling its buffer, a power-of-two n0 in a longer one (these
# two also against the JAX package: each of its lengths is a compile there),
# odd n0 in longer buffers
EQ_LENGTHS = [(12007, 12007, 44100), (8192, 9000, 48000), (4801, 6000, 8000),
              (777, 1024, 48000), (97, 97, 8000)]
JAX_EQ_LENGTHS = EQ_LENGTHS[:2]


def eq_input(n0, n_total, channels, seed):
    x = np.random.default_rng(seed).standard_normal((channels, n_total)).astype(np.float32)
    x[:, n0:] = 0.0
    return x


def shelf_direct(x, n0, rate, bass, treble):
    return filters.apply_shelf_eq(torch.from_numpy(x[None, :, :n0]), rate,
                                  torch.tensor([bass]), torch.tensor([treble]))[0].numpy()


def air_direct(x, n0, rate, factor):
    return filters.apply_air_absorption(torch.from_numpy(x[None, :, :n0]), rate,
                                        torch.tensor([factor]))[0].numpy()


@pytest.mark.parametrize("n0, n_total, rate", JAX_EQ_LENGTHS)
def test_shelf_eq_streaming_matches_filters_and_jax(n0, n_total, rate, record_property):
    x = eq_input(n0, n_total, 2, n0)
    got = streaming_eq.shelf_eq_streaming(torch.from_numpy(x), n0, rate, 1.7, 0.55).numpy()
    want = np.asarray(jstreaming_eq.shelf_eq_streaming(jnp.asarray(x), n0, rate, 1.7, 0.55))
    gaps = [float(np.abs(got[:, :n0] - shelf_direct(x, n0, rate, 1.7, 0.55)).max()),
            float(np.abs(got - want).max())]
    record_property("max_abs_vs_filters_and_jax", gaps)
    assert max(gaps) <= BLUESTEIN_TOL
    assert not got[:, n0:].any()  # positions past the signal come back zero


@pytest.mark.parametrize("n0, n_total, rate", JAX_EQ_LENGTHS)
def test_air_absorption_streaming_matches_filters_and_jax(n0, n_total, rate, record_property):
    x = eq_input(n0, n_total, 2, n0 + 1)
    got = streaming_eq.air_absorption_streaming(torch.from_numpy(x), n0, rate, 0.7).numpy()
    want = np.asarray(jstreaming_eq.air_absorption_streaming(jnp.asarray(x), n0, rate, 0.7))
    gaps = [float(np.abs(got[:, :n0] - air_direct(x, n0, rate, 0.7)).max()),
            float(np.abs(got - want).max())]
    record_property("max_abs_vs_filters_and_jax", gaps)
    assert max(gaps) <= BLUESTEIN_TOL
    assert not got[:, n0:].any()


@pytest.mark.parametrize("n0, n_total, rate", EQ_LENGTHS)
@pytest.mark.parametrize("channels", [1, 3])
def test_odd_channel_counts(n0, n_total, rate, channels):
    """One channel alone, and a pair plus one: each channel equals the direct
    filter on its own (the L + iR packing leaks nothing across)."""
    x = eq_input(n0, n_total, channels, n0 + channels)
    eq = streaming_eq.shelf_eq_streaming(torch.from_numpy(x), n0, rate, 1.7, 0.55).numpy()
    air = streaming_eq.air_absorption_streaming(torch.from_numpy(x), n0, rate, 0.7).numpy()
    assert np.abs(eq[:, :n0] - shelf_direct(x, n0, rate, 1.7, 0.55)).max() <= BLUESTEIN_TOL
    assert np.abs(air[:, :n0] - air_direct(x, n0, rate, 0.7)).max() <= BLUESTEIN_TOL
    assert not eq[:, n0:].any() and not air[:, n0:].any()


def test_eq_unity_gains_and_gain_clip():
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 1501)).astype(np.float32)
    same = streaming_eq.shelf_eq_streaming(torch.from_numpy(x), 1501, 22050, 1.0, 1.0).numpy()
    assert np.abs(same - x).max() <= 5e-6
    # gains outside EQ_GAIN_CLIP clip as in the single-shot path
    y = r.standard_normal((1, 2001)).astype(np.float32)
    got = streaming_eq.shelf_eq_streaming(torch.from_numpy(y), 2001, 8000, 99.0, 0.0).numpy()
    assert np.abs(got - shelf_direct(y, 2001, 8000, 99.0, 0.0)).max() <= BLUESTEIN_TOL


def test_short_signals_are_the_identity_and_long_ones_refused():
    buf = torch.arange(8, dtype=torch.float32)[None]
    for n0 in (0, 1):
        assert streaming_eq.shelf_eq_streaming(buf, n0, 8000, 1.5, 1.0) is buf
        assert streaming_eq.air_absorption_streaming(buf, n0, 8000, 0.5) is buf
    with pytest.raises(ValueError, match=r"exact streaming EQ supports n0 < 2\^30"):
        streaming_eq.shelf_eq_streaming(buf, 1 << 30, 48000, 1.5, 1.0)
    with pytest.raises(ValueError, match=r"exact streaming air absorption supports n0 < 2\^30"):
        streaming_eq.air_absorption_streaming(buf, 1 << 30, 48000, 0.5)
    for package in (jstreaming_eq, streaming_eq):
        with pytest.raises(ValueError, match=r"2\^30"):
            package.shelf_eq_streaming(jnp.zeros((1, 8)) if package is jstreaming_eq else buf,
                                       1 << 30, 48000, 1.5, 1.0)


def test_bluestein_length_is_the_power_of_two_past_twice_n():
    for n in (1, 2, 3, 5, 97, 4801, 86_490_503):
        m = streaming_eq.bluestein_length(n)
        assert m >= 2 * n - 1 and m & (m - 1) == 0 and (m == 1 or m // 2 < 2 * n - 1)
    assert math.log2(streaming_eq.bluestein_length(86_490_503)) == 28


def numpy_curves(n, rate):
    """The reference's curves from ``np.fft.rfftfreq`` on the host (float64)."""
    freqs = np.fft.rfftfreq(n, d=1.0 / rate)
    start = config.AIR_ABSORPTION_START_HZ
    ramp = np.zeros_like(freqs)
    if freqs[-1] > start:
        ramp = np.where(freqs >= start,
                        np.clip((freqs - start) / (freqs[-1] - start), 0.0, 1.0), 0.0)
    bass = (freqs > 1e-6) & (freqs <= config.EQ_BASS_CUTOFF_HZ)
    return ramp.astype(np.float32), bass, freqs >= config.EQ_TREBLE_CUTOFF_HZ


@pytest.mark.parametrize("n, rate", [(2, 8000), (777, 48000), (4801, 8000), (12007, 44100),
                                     (2_951_999, 48000), (3_155_898, 44100), (864_905, 22050)])
def test_gain_curves_built_on_the_device_equal_numpy_bit_for_bit(n, rate):
    """``ops.filters`` builds its curves on the signal's device (nothing kept
    on the host for a long length): the same bits as the float64 numpy
    curves, edge bins included (250 Hz lands with float dust at 44.1 kHz)."""
    ramp, bass, treble = numpy_curves(n, rate)
    got_bass, got_treble = filters._shelf_masks(n, rate, "cpu")
    assert np.array_equal(filters._air_ramp(n, rate, "cpu").numpy(), ramp)
    assert np.array_equal(got_bass.numpy(), bass) and np.array_equal(got_treble.numpy(), treble)
