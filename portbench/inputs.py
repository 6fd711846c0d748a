"""Inputs made from the run's seed: clips on the device, staged on the host.

Each clip is the bench line's kind of signal (two tones plus noise, as the
``0xBE7C`` generator of the port's bench tools makes them).  The clips are
made on the device, in blocks of rows, with noise from a ``torch.Generator``
seeded from the run's seed, and copied once into the host arrays the
harness hands to the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS_PER_BLOCK = 16
# (low, high) of the two tones' frequencies (Hz) and levels
TONE_RANGES = ((110.0, 440.0), (800.0, 3200.0), (0.2, 0.35), (0.03, 0.07))
NOISE_LEVEL = 0.02


def clips_into(dest: np.ndarray, seed: int, rate: int, device, lengths=None) -> None:
    """Fill ``dest`` (rows, n, channels) float32 with clips made from
    ``seed``; row r is zero from ``lengths[r]`` on when ``lengths`` is given.

    The tones' frequencies and levels are one fixed set of values spread
    over their ranges, dealt to the rows in an order drawn from the seed,
    and the noise is drawn on the device: every seed gives the card the
    same set of signals to work on, in another order."""
    rows, n, channels = dest.shape
    order = np.random.default_rng(seed)
    count = rows * channels
    tones = np.stack([spread(order, count, lo, hi) for lo, hi in TONE_RANGES], axis=-1)
    tones = torch.as_tensor(tones.reshape(rows, channels, len(TONE_RANGES)), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    for r0 in range(0, rows, ROWS_PER_BLOCK):
        b = min(ROWS_PER_BLOCK, rows - r0)
        f1, f2, a1, a2 = (tones[r0:r0 + b, :, k:k + 1] for k in range(4))
        tone = a1 * torch.sin(2 * math.pi * f1 * t) + a2 * torch.sin(2 * math.pi * f2 * t)
        noise = torch.randn((b, channels, n), generator=gen, device=device, dtype=torch.float32)
        clip = (tone.to(torch.float32) + NOISE_LEVEL * noise).transpose(1, 2)
        if lengths is not None:
            idx = torch.arange(n, device=device)
            keep = idx[None, :] < torch.as_tensor(lengths[r0:r0 + b], device=device)[:, None]
            clip = clip * keep[:, :, None]
        torch.from_numpy(dest[r0:r0 + b]).copy_(clip)


def distinct_seeds(rng: np.random.Generator, count: int) -> list:
    """``count`` distinct uint32 render seeds (an odd multiplier is a
    bijection modulo 2^32)."""
    base = int(rng.integers(0, 2 ** 32))
    return [(base + i * 2654435761) & 0xFFFFFFFF for i in range(count)]


def spread(rng: np.random.Generator, count: int, lo: float, hi: float) -> np.ndarray:
    """``count`` values evenly over [lo, hi], in an order drawn from ``rng``:
    every seed gets the same set, in another order."""
    return rng.permutation(np.linspace(lo, hi, count))
