"""The port's counter-based stream (audio_raytracing_studio_tpu_torch/ops/rng.py)
against the JAX package's (ops/rng.py): bit-equal bits and floats for every
stream salt, over 2^20 counters, with seeds that include ≥ 2^31.

Tolerance: none — the stream is integer arithmetic plus an exact bit-cast,
so the two packages must agree bit for bit (PARITY.md "seed streams v2").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.ops import rng as jrng
from audio_raytracing_studio_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

N_COUNTERS = 1 << 20
SEEDS = [0, 7, 2**31, 0xFFFFFFFF]
SALTS = {
    "delay": (jrng.DELAY_STREAM, trng.DELAY_STREAM),
    "strength": (jrng.STRENGTH_STREAM, trng.STRENGTH_STREAM),
    "noise": (jrng.NOISE_STREAM, trng.NOISE_STREAM),
}


def test_constants_match():
    assert int(jrng.PHI) == trng.PHI
    for j_salt, t_salt in SALTS.values():
        assert int(j_salt) == t_salt


@pytest.mark.parametrize("salt", sorted(SALTS))
@pytest.mark.parametrize("seed", SEEDS)
def test_counter_bits_and_uniform_bit_equal(seed, salt):
    j_salt, t_salt = SALTS[salt]
    index = np.arange(N_COUNTERS, dtype=np.uint32)
    j_bits = np.asarray(
        jrng.counter_bits(jrng.stream_mix(jnp.asarray(np.uint32(seed)), j_salt),
                          jnp.asarray(index))
    )
    t_bits = trng.counter_bits(
        trng.stream_mix(seed, t_salt), torch.from_numpy(index.astype(np.int64))
    )
    assert t_bits.dtype == torch.int64
    np.testing.assert_array_equal(t_bits.numpy(), j_bits.astype(np.int64))

    for lo, hi in ((-1.0, 1.0), (0.3, 0.8)):
        j_u = np.asarray(jrng.uniform_from_bits(jnp.asarray(j_bits), lo, hi))
        t_u = trng.uniform_from_bits(t_bits, lo, hi).numpy()
        assert t_u.dtype == np.float32
        np.testing.assert_array_equal(t_u.view(np.int32), j_u.view(np.int32))


def test_stream_mix_tensor_and_int_agree():
    """A seed tensor (the bank's int32 carrier of a ≥ 2^31 seed) and the
    Python int give the same mixing constant."""
    seeds = [0, 7, 2**31, 0xFFFFFFFF]
    carrier = torch.from_numpy(np.asarray(seeds, np.uint32).view(np.int32))
    mixed = trng.stream_mix(carrier, trng.NOISE_STREAM)
    assert mixed.tolist() == [trng.stream_mix(s, trng.NOISE_STREAM) for s in seeds]


def test_lowbias32_wraps_like_uint32():
    """int64 products past 2^63 wrap mod 2^64; the low 32 bits stay right."""
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    want = np.asarray(jrng.lowbias32(jnp.asarray(x))).astype(np.int64)
    got = trng.lowbias32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert [trng.lowbias32(int(v)) for v in x] == want.tolist()
