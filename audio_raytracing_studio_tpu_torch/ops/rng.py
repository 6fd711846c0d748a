"""Counter-based random stream — port of ``audio_raytracing_studio_tpu/ops/rng.py``.

Every draw is a pure function of ``(seed, stream, index)``:

    bits(index) = lowbias32(stream_mix + index * PHI)
    stream_mix  = lowbias32(seed ^ stream_salt)

so the same seed gives the same bits here, in the JAX package and inside
the CUDA RIR-bank kernel (PARITY.md "seed streams v2").

PyTorch has no uint32 ``>>``, ``+`` or ``%`` on the CPU, so values are
carried in int64 and masked to 32 bits after each step.  A 32×32-bit
product may pass 2^63; it then wraps modulo 2^64 and its low 32 bits stay
right.  Every function here also takes plain Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHI = 0x9E3779B9  # 2^32 / golden ratio — Weyl increment

# Distinct salts → independent streams per draw family.
DELAY_STREAM = 0xA511E9B3
STRENGTH_STREAM = 0x63D83595
NOISE_STREAM = 0xC2B2AE35


def lowbias32(x):
    """32-bit avalanche hash (lowbias32) on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    x = x ^ (x >> 16)
    return x


def stream_mix(seed, stream_salt: int):
    """Per-(seed, stream) mixing constant; ``seed`` is any int or int tensor,
    of which only the low 32 bits count (seeds ≥ 2^31 wrap as in JAX)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64)
    return lowbias32((seed & MASK32) ^ stream_salt)


def counter_bits(mix, index):
    """Random uint32 bits (in int64) for each counter value ``index``."""
    if isinstance(index, torch.Tensor):
        index = index.to(torch.int64)
    return lowbias32((mix + (index & MASK32) * PHI) & MASK32)


def uniform_from_bits(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """uint32 bits → float32 uniform [lo, hi) via the mantissa trick."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    one_to_two = mantissa.view(torch.float32)
    return lo + (one_to_two - 1.0) * float(np.float32(hi - lo))
