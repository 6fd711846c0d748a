"""The port's distributed exact-length DFT and shelf EQ
(``parallel/distributed_fft.py``) on a CPU block mesh of 8 shards, at the
tolerances of ``tests/test_distributed_fft.py`` against NumPy (relative
1e-6 for the four-step FFT, 1e-5 for its round trip, 2e-6 for the exact
DFT, 3e-6 for the EQ), and against the JAX package's functions on the
conftest's virtual devices (the chirps to 1e-6 — the port's angles are
float64, the JAX package's float32; the EQ to 2e-5; gaps recorded with
``record_property``).  The integer parts are exact: ``_modsq`` against
Python ints and the JAX package's int32 version, the band edges bit-equal to
the single-device ``rfftfreq`` masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from audio_raytracing_studio_tpu.parallel import distributed_fft as jdfft
from audio_raytracing_studio_tpu.parallel import mesh as jmesh
from audio_raytracing_studio_tpu_torch.parallel import distributed_fft as dfft
from audio_raytracing_studio_tpu_torch.parallel import mesh

torch.set_num_threads(1)

D = 8


@pytest.fixture(scope="module")
def axis():
    return mesh.make_mesh(data=1, block=D, devices=["cpu"] * D).axis("block")


def split(x, parts=D):
    n = x.shape[-1] // parts
    return [torch.from_numpy(np.ascontiguousarray(x[..., c * n:(c + 1) * n])) for c in range(parts)]


def joined(shards):
    return np.concatenate([s.numpy() for s in shards], axis=-1)


def test_modsq_exact_against_python_ints_and_jax():
    js = np.array([0, 1, 2, 32767, 32768, 123456789, (1 << 30) - 1], np.int64)
    for modulus in (7, 48000 * 2, (1 << 31) - 1, 2 * 346809):
        got = dfft._modsq(torch.from_numpy(js), modulus).tolist()
        assert got == [(int(j) * int(j)) % modulus for j in js], modulus
        assert got == np.asarray(jdfft._modsq(jnp.asarray(js.astype(np.int32)), modulus)).tolist()


def test_band_edges_match_rfftfreq_masks_and_jax():
    rng = np.random.default_rng(6)
    cases = [(44100, 2646 * k) for k in (1, 7, 100, 1167)]  # 250 Hz edge bins
    cases += [(44100, 441 * k) for k in (10, 70, 700)]
    cases += [(48000, 192 * k) for k in (1, 125, 1000)]  # exact edges at 48 kHz
    cases += [(int(rate), int(n0)) for rate in (8000, 16000, 22050, 44100, 48000, 96000)
              for n0 in rng.integers(16, 500_000, size=8)]
    for rate, n0 in cases:
        freqs = np.fft.rfftfreq(n0, d=1.0 / rate)
        k_lo, k_bass, k_treble = dfft.band_edges(n0, rate)
        assert (k_lo, k_bass, k_treble) == tuple(jdfft._band_edges(n0, rate)), (rate, n0)
        k = np.arange(freqs.size)
        assert (((k >= k_lo) & (k <= k_bass)) == ((freqs > 1e-6) & (freqs <= 250.0))).all()
        assert ((k >= k_treble) == (freqs >= 4000.0)).all(), (rate, n0)


def test_shelf_gain_and_chirp_kernel_match_jax(record_property):
    n0, m, rate = 24001, 65536, 8000
    k = np.arange(m)
    gain = dfft.shelf_gain_at_bins(torch.from_numpy(k), n0, rate, 1.6, 0.6).numpy()
    want = np.asarray(jdfft.shelf_gain_at_bins(jnp.asarray(k.astype(np.int32)), n0, rate,
                                               jnp.float32(1.6), jnp.float32(0.6)))
    assert np.array_equal(gain, want)
    for sign in (-1.0, 1.0):
        got = dfft.chirp_kernel_at_bins(torch.from_numpy(k), n0, m, sign).numpy()
        ref = np.asarray(jdfft.chirp_kernel_at_bins(jnp.asarray(k.astype(np.int32)), n0, m, sign))
        gap = float(np.abs(got - ref).max())
        record_property(f"chirp_kernel_vs_jax_{int(sign)}", gap)
        assert gap <= 1e-6
        assert not got[n0:m - n0 + 1].any()


def test_dist_fft_matches_numpy(axis):
    rng = np.random.default_rng(2)
    b_m = 256
    x = (rng.standard_normal(D * b_m) + 1j * rng.standard_normal(D * b_m)).astype(np.complex64)
    strided = dfft.dist_fft(axis, split(x))
    X = np.zeros(D * b_m, np.complex64)
    for c in range(D):  # shard c holds bins c + D·t
        X[c::D] = strided[c].numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-6


def test_dist_fft_ifft_roundtrip(axis):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    y = joined(dfft.dist_ifft(axis, dfft.dist_fft(axis, split(x))))
    assert np.abs(y - x).max() < 1e-5


@pytest.mark.parametrize("n0", [1000, 3658])
def test_dist_dft_exact_matches_numpy(axis, n0):
    rng = np.random.default_rng(4)
    b_sig = dfft.block_len_for(n0, D)
    x = np.zeros(b_sig * D, np.float32)
    x[:n0] = rng.standard_normal(n0).astype(np.float32) * 0.3
    X = joined(dfft.dist_dft_exact(axis, split(x), n0))
    ref = np.fft.fft(x[:n0].astype(np.float64))
    assert np.abs(X[:n0] - ref).max() / np.abs(ref).max() < 2e-6
    assert np.abs(X[n0:]).max() == 0.0  # padding stays clean
    back = joined(dfft.dist_dft_exact(axis, split(X), n0, inverse=True))
    assert np.abs(back[:n0] - x[:n0]).max() < 1e-5


def test_shelf_eq_sharded_matches_exact_and_jax(axis, record_property):
    rng = np.random.default_rng(5)
    n0, rate = 24001, 8000
    b_sig = dfft.block_len_for(n0, D)
    x = np.zeros(b_sig * D, np.float32)
    x[:n0] = rng.standard_normal(n0).astype(np.float32) * 0.3
    y = joined(dfft.shelf_eq_sharded(axis, split(x), rate, 1.6, 0.6, n0))
    freqs = np.fft.rfftfreq(n0, d=1.0 / rate)
    g = np.ones_like(freqs)
    g[(freqs > 1e-6) & (freqs <= 250.0)] = 1.6
    g[freqs >= 4000.0] = 0.6
    ref = np.fft.irfft(np.fft.rfft(x[:n0].astype(np.float64)) * g, n0)
    assert np.abs(y[:n0] - ref).max() < 3e-6
    assert not y[n0:].any()

    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    jm = jmesh.make_mesh(data=1, block=D, devices=jax.devices()[:D])

    def geq(xb):
        return jdfft.shelf_eq_sharded(xb, rate, jnp.float32(1.6), jnp.float32(0.6), n0,
                                      "block", D)

    want = np.asarray(jax.jit(jax.shard_map(geq, mesh=jm, in_specs=P("block"),
                                            out_specs=P("block"), check_vma=False))(
        jnp.asarray(x)))
    gap = float(np.abs(y - want).max())
    record_property("max_abs_vs_jax", gap)
    assert gap <= 2e-5


def test_layout_and_axis_errors(axis):
    with pytest.raises(ValueError, match="does not align"):
        dfft.dist_dft_exact(axis, split(np.zeros(8 * 100, np.float32)), 1000)
    three = mesh.make_mesh(data=1, block=3, devices=["cpu"] * 3).axis("block")
    with pytest.raises(ValueError, match="power-of-two"):
        dfft.shelf_eq_sharded(three, split(np.zeros(3 * 4, np.float32), 3), 8000, 1.5, 1.0, 10)
