"""The port's length-dynamic exact shelf EQ (``ops/filters.apply_shelf_eq_dynamic``,
``EQDyn``, ``eq_dyn_host``) and its chirp arithmetic (``ops/chirp.py``), on
the CPU at 16 kHz and L of 12,000-20,000 samples.

Held to the JAX package's ``ops/chirp.py`` (residues and band edges exactly;
chirps, kernels and gains to 1e-6 — the port's angles are float64, the JAX
package's float32), to the JAX ``filters.apply_shelf_eq_dynamic`` applied
row by row with ``eq_dyn_host`` (2e-5 max-abs on unit-peak inputs), and to
the port's exact-length plain version ``apply_shelf_eq_padded`` (2e-5).
Output past each row's true length is exactly zero.  The FFT shapes the
dynamic EQ issues are recorded for two batches with disjoint true lengths:
they must be equal — what stands in here for the cuFFT plan count — and
``render_batch`` must send every padded EQ-on batch through it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.ops import chirp as jchirp
from audio_raytracing_studio_tpu.ops import filters as jfilters
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.ops import chirp, filters
from audio_raytracing_studio_tpu_torch.parallel import sharding

torch.set_num_threads(1)

RATE = 16000
TOL = 2e-5
CHIRP_TOL = 1e-6


def true_lengths(length):
    """n0 ∈ {L, L − 1, a prime, about L/2, at most 8} for one padded length."""
    prime = next(p for p in range(length - 40, 0, -1)
                 if all(p % d for d in range(2, int(p ** 0.5) + 1)))
    return [length, length - 1, prime, length // 2 + 3, 7]


def padded_batch(seed, channels, length, lengths):
    """(B, C, L) float32, each row unit-peak on [0, n0) and zero past it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), channels, length)).astype(np.float32)
    for b, n0 in enumerate(lengths):
        x[b, :, n0:] = 0.0
        x[b] /= np.abs(x[b]).max()
    return x


# Gains inside and outside config.EQ_GAIN_CLIP = (0.1, 5.0): 0.0, 0.05 and 9.0 clip.
BASS = np.array([1.6, 0.0, 9.0, 0.7, 2.5], np.float32)
TREBLE = np.array([0.7, 3.5, 0.05, 1.0, 9.0], np.float32)


def host_dyn(lengths):
    """An EQDyn of per-row host ints."""
    return filters.EQDyn(*zip(*(filters.eq_dyn_host(n0, RATE) for n0 in lengths)))


# ---------------------------------------------------------------------------
# ops/chirp against the JAX package's
# ---------------------------------------------------------------------------


def test_fft_length_for_matches_jax():
    for n in (1, 2, 3, 5, 8, 9, 12_000, 2_951_999, 86_490_503):
        assert chirp.fft_length_for(n) == jchirp.fft_length_for(n), n


def test_band_edges_bit_equal_to_jax():
    rng = np.random.default_rng(11)
    cases = [(44100, 2646 * k) for k in (1, 7, 100, 1167)]  # 250 Hz lands on a bin, with dust
    cases += [(44100, 441 * k) for k in (10, 70, 700)]  # 4 kHz edge bins at 44.1 kHz
    cases += [(44100, n0) for n0 in (1, 2, 3, 5, 8)]
    cases += [(int(rate), int(n0)) for rate in (8000, 16000, 22050, 44100, 48000)
              for n0 in rng.integers(9, 3_000_000, size=6)]
    for rate, n0 in cases:
        assert chirp.band_edges(n0, rate) == tuple(jchirp.band_edges(n0, rate)), (rate, n0)
        want = jfilters.eq_dyn_host(n0, rate)
        assert tuple(filters.eq_dyn_host(n0, rate)) == tuple(int(v) for v in want), (rate, n0)


def test_modsq_residues_equal_jax():
    js = np.array([0, 1, 2, 7, 32767, 32768, 123_456, 2_951_998, (1 << 23) - 1], np.int64)
    for modulus in (2, 14, 2 * 12_001, 2 * 2_951_999, 2 * 86_490_503):
        want = np.asarray(jchirp._modsq(jnp.asarray(js.astype(np.int32)), modulus)).tolist()
        assert chirp._modsq(torch.from_numpy(js), modulus).tolist() == want, modulus
    # per-row moduli broadcasting against the indices, as the dynamic EQ calls it
    rows = torch.tensor([[2 * 12_001], [14], [2 * 2_951_999]], dtype=torch.int64)
    got = chirp._modsq(torch.from_numpy(js)[None, :], rows).numpy()
    for r, modulus in enumerate(rows[:, 0].tolist()):
        want = np.asarray(jchirp._modsq(jnp.asarray(js.astype(np.int32)), modulus))
        np.testing.assert_array_equal(got[r], want)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_chirps_kernels_and_gains_match_jax(sign, record_property):
    length = 12_000
    lengths = true_lengths(length)
    m = chirp.fft_length_for(length)
    n0 = torch.tensor(lengths, dtype=torch.int64)[:, None]
    j = torch.arange(length, dtype=torch.int64)
    k = torch.arange(m, dtype=torch.int64)
    w = chirp._chirp(j, n0, sign).numpy()
    kern = chirp.chirp_kernel_at_bins(k, n0, m, sign).numpy()
    dyn = host_dyn(lengths)
    edges = [torch.tensor(f, dtype=torch.int64)[:, None] for f in dyn[1:]]
    gain = chirp.shelf_gain_from_edges(k, n0, *edges, torch.from_numpy(BASS)[:, None],
                                       torch.from_numpy(TREBLE)[:, None]).numpy()
    worst = 0.0
    for r, n in enumerate(lengths):
        valid = np.arange(length) < n
        want_w = np.asarray(jchirp._chirp(jnp.arange(length, dtype=jnp.int32), n, sign))
        worst = max(worst, float(np.abs(w[r][valid] - want_w[valid]).max()))
        want_k = np.asarray(jchirp.chirp_kernel_at_bins(jnp.arange(m, dtype=jnp.int32), n, m,
                                                        sign))
        assert np.array_equal(kern[r] == 0, want_k == 0), n
        worst = max(worst, float(np.abs(kern[r] - want_k).max()))
        want_g = np.asarray(jchirp.shelf_gain_from_edges(
            jnp.arange(m, dtype=jnp.int32), n, *(int(f[r]) for f in dyn[1:]),
            BASS[r], TREBLE[r]))
        np.testing.assert_array_equal(gain[r], want_g)
    record_property("chirp_max_abs", worst)
    assert worst <= CHIRP_TOL


# ---------------------------------------------------------------------------
# apply_shelf_eq_dynamic against JAX and against the exact-length plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_dynamic_eq_matches_jax_row_by_row(channels, record_property):
    length = 12_000
    lengths = true_lengths(length)
    x = padded_batch(channels, channels, length, lengths)
    got = filters.apply_shelf_eq_dynamic(torch.from_numpy(x), torch.from_numpy(BASS),
                                         torch.from_numpy(TREBLE), host_dyn(lengths)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    worst = 0.0
    for b, n0 in enumerate(lengths):
        want = np.asarray(jfilters.apply_shelf_eq_dynamic(
            jnp.asarray(x[b]), jnp.float32(BASS[b]), jnp.float32(TREBLE[b]),
            jfilters.eq_dyn_host(n0, RATE)))
        worst = max(worst, float(np.abs(got[b] - want).max()))
        assert not got[b, :, n0:].any(), f"row {b} not zero past n0 = {n0}"
    record_property("max_abs_vs_jax", worst)
    assert worst <= TOL


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_dynamic_eq_matches_exact_length_plain_version(channels, record_property):
    length = 20_000
    lengths = true_lengths(length) + [length - 4321]  # B = 6: two row passes
    bass = np.append(BASS, 1.2).astype(np.float32)
    treble = np.append(TREBLE, 0.8).astype(np.float32)
    x = torch.from_numpy(padded_batch(10 + channels, channels, length, lengths))
    bg, tg = torch.from_numpy(bass), torch.from_numpy(treble)
    got = filters.apply_shelf_eq_dynamic(x, bg, tg, host_dyn(lengths))
    want = filters.apply_shelf_eq_padded(x, RATE, bg, tg, lengths)
    err = float((got - want).abs().max())
    record_property("max_abs_vs_padded", err)
    assert err <= TOL
    for b, n0 in enumerate(lengths):
        assert not got[b, :, n0:].any(), f"row {b} not zero past n0 = {n0}"


def test_stacked_device_rows_equal_host_rows():
    """EQDyn.stack (one (4, B) table, what render_batch uploads) gives the
    same output as per-row host ints."""
    length = 12_000
    lengths = true_lengths(length)
    x = torch.from_numpy(padded_batch(3, 2, length, lengths))
    bg, tg = torch.from_numpy(BASS), torch.from_numpy(TREBLE)
    stacked = filters.EQDyn.stack([filters.eq_dyn_host(n0, RATE) for n0 in lengths], "cpu")
    assert all(f.dtype == torch.int64 and f.shape == (len(lengths),) for f in stacked)
    assert stacked.n0.tolist() == lengths
    a = filters.apply_shelf_eq_dynamic(x, bg, tg, stacked)
    b = filters.apply_shelf_eq_dynamic(x, bg, tg, host_dyn(lengths))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# FFT shapes depend on (B, L) alone; render_batch routes through the dynamic EQ
# ---------------------------------------------------------------------------


def record_ffts(monkeypatch):
    """Wrap torch.fft's transforms; returns the list each call appends
    (name, input shape, n, dim) to."""
    calls = []
    for name in ("fft", "ifft", "rfft", "irfft"):
        real = getattr(torch.fft, name)

        def wrapper(x, n=None, dim=-1, norm=None, *, _real=real, _name=name):
            calls.append((_name, tuple(x.shape), n, dim))
            return _real(x, n=n, dim=dim, norm=norm)

        monkeypatch.setattr(torch.fft, name, wrapper)
    return calls


def test_fft_shapes_do_not_depend_on_true_lengths(monkeypatch):
    length, batch = 16_000, 6
    first = [length - 13 * b for b in range(batch)]
    second = [length // 2 + 101 * b + 1 for b in range(batch)]
    assert not set(first) & set(second)
    x = torch.from_numpy(padded_batch(5, 2, length, [length] * batch))
    bg = torch.full((batch,), 1.8)
    tg = torch.full((batch,), 0.5)
    records = []
    for lengths in (first, second):
        calls = record_ffts(monkeypatch)
        filters.apply_shelf_eq_dynamic(x, bg, tg, host_dyn(lengths))
        monkeypatch.undo()
        records.append(calls)
    assert records[0] == records[1]
    m = chirp.fft_length_for(length)
    for name in ("fft", "ifft"):
        shapes = {c[1] for c in records[0] if c[0] == name}
        assert shapes == {(filters.EQ_DYN_ROWS, m), (batch % filters.EQ_DYN_ROWS, m)}, name
    assert {c[0] for c in records[0]} == {"fft", "ifft"}


def padded_clips(lengths, n_in):
    rng = np.random.default_rng(4)
    clips = (rng.standard_normal((len(lengths), n_in)) * 0.3).astype(np.float32)
    for b, tl in enumerate(lengths):
        clips[b, tl:] = 0.0
    return clips


@pytest.mark.parametrize("case", ["padded eq on", "padded eq off", "unpadded eq on"])
def test_render_batch_routes_padded_eq_through_dynamic_eq(case, monkeypatch):
    n_in = RATE // 2
    lengths = [n_in, n_in - 321, n_in - 1000] if case != "unpadded eq on" else [n_in] * 3
    eq = {} if case == "padded eq off" else dict(bass_gain=1.8, treble_gain=0.5)
    params = [RenderParams(target_layout="Stereo", room_size=40.0, **eq)] * 3
    seen = []
    real = filters.apply_shelf_eq_dynamic

    def spy(signal, bass_gain, treble_gain, dyn):
        seen.append(dyn.n0.tolist())
        return real(signal, bass_gain, treble_gain, dyn)

    def refuse(*args, **kwargs):
        raise AssertionError("the render path reached the plain per-length EQ")

    monkeypatch.setattr(filters, "apply_shelf_eq_dynamic", spy)
    monkeypatch.setattr(filters, "apply_shelf_eq_padded", refuse)
    out = sharding.render_batch(padded_clips(lengths, n_in), RATE, params, seeds=[0, 1, 2],
                                clip_lengths=lengths, device="cpu")
    ir_len = out.shape[1] - n_in + 1
    if case == "padded eq on":
        assert seen == [[tl + ir_len - 1 for tl in lengths]]
        for b, tl in enumerate(lengths):
            assert not out[b, tl + ir_len - 1:].any()
    else:
        assert seen == []

