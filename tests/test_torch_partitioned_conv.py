"""The port's block-partitioned overlap-add convolution
(``parallel/partitioned_conv.py``) on CPU meshes, against scipy's
``fftconvolve`` at the JAX test's bound (2e-4, ``tests/test_parallel.py``
TestPartitionedConv) and against the JAX package's ``partitioned_convolve``
on the conftest's virtual devices (≤ 2e-5, float32 round-off between two
FFT libraries; the gap recorded with ``record_property``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from audio_raytracing_studio_tpu.parallel import mesh as jmesh
from audio_raytracing_studio_tpu.parallel import partitioned_conv as jpc
from audio_raytracing_studio_tpu_torch.parallel import mesh, partitioned_conv

torch.set_num_threads(1)

TOL = 2e-4
JAX_TOL = 2e-5


def cpu_mesh(data, block):
    return mesh.make_mesh(data=data, block=block, devices=["cpu"] * (data * block))


def padded(sig, n_pad):
    return np.pad(sig, ((0, 0), (0, n_pad - sig.shape[1])))


@pytest.mark.parametrize("n,l", [(4096, 1000), (8192, 9000), (2048, 100)])
def test_matches_fftconvolve(rng, n, l):
    sig = rng.standard_normal((2, n)).astype(np.float32) * 0.3
    ker = rng.standard_normal((2, l)).astype(np.float32) * 0.05
    n_pad = partitioned_conv.padded_length(n, l, 8)
    out = partitioned_conv.partitioned_convolve(padded(sig, n_pad), ker, cpu_mesh(1, 8)).numpy()
    assert out.shape == (2, 2, n_pad)
    for ki in range(2):
        for ci in range(2):
            ref = fftconvolve(sig[ci], ker[ki], mode="full")
            np.testing.assert_allclose(out[ki, ci, : n + l - 1], ref, atol=TOL)
            # beyond the linear-conv support everything is zero
            assert np.max(np.abs(out[ki, ci, n + l - 1:])) < 1e-6


def test_tail_longer_than_block(rng):
    """L−1 spanning several blocks: multi-hop ring forwarding."""
    n, l = 1024, 700  # block 216, tail 699 → 4 hops
    sig = rng.standard_normal((1, n)).astype(np.float32)
    ker = rng.standard_normal((1, l)).astype(np.float32)
    n_pad = partitioned_conv.padded_length(n, l, 8)
    out = partitioned_conv.partitioned_convolve(padded(sig, n_pad), ker, cpu_mesh(1, 8)).numpy()
    np.testing.assert_allclose(out[0, 0, : n + l - 1], fftconvolve(sig[0], ker[0]), atol=TOL)


@pytest.mark.parametrize("data,block", [(1, 8), (2, 4)])
def test_matches_jax_partitioned_convolve(rng, record_property, data, block):
    if len(jax.devices()) < data * block:
        pytest.skip("needs 8 virtual devices")
    n, l = 2048, 600
    sig = rng.standard_normal((2, n)).astype(np.float32) * 0.2
    ker = rng.standard_normal((2, l)).astype(np.float32) * 0.05
    n_pad = partitioned_conv.padded_length(n, l, block)
    assert n_pad == jpc.padded_length(n, l, block)
    got = partitioned_conv.partitioned_convolve(padded(sig, n_pad), torch.from_numpy(ker),
                                                cpu_mesh(data, block)).numpy()
    want = np.asarray(jpc.partitioned_convolve(
        jnp.asarray(padded(sig, n_pad)), jnp.asarray(ker),
        jmesh.make_mesh(data=data, block=block, devices=jax.devices()[: data * block])))
    gap = float(np.abs(got - want).max())
    record_property("max_abs_vs_jax", gap)
    assert got.shape == want.shape and gap <= JAX_TOL


def test_wrap_free_ring_drops_what_comes_around():
    """``wrap=False`` is the truncated linear convolution: the last shard's
    spill never lands on shard 0 (the sharded meter's FIR runs to the grid's end)."""
    axis = cpu_mesh(1, 4).axis("block")
    locals_ = [torch.zeros(1, 4) for _ in range(4)]
    tails = [torch.zeros(1, 6) for _ in range(3)] + [torch.arange(1.0, 7.0)[None]]
    wrapped = partitioned_conv._ring_overlap_add(axis, locals_, tails, 4)
    linear = partitioned_conv._ring_overlap_add(axis, locals_, tails, 4, wrap=False)
    assert wrapped[0].tolist() == [[1.0, 2.0, 3.0, 4.0]] and wrapped[1].tolist() == [[5.0, 6.0, 0.0, 0.0]]
    assert all(not t.any() for t in linear)


def test_signal_length_must_divide(rng):
    with pytest.raises(ValueError, match="not divisible by 8"):
        partitioned_conv.partitioned_convolve(np.zeros((1, 1001), np.float32),
                                              np.ones((1, 3), np.float32), cpu_mesh(1, 8))
