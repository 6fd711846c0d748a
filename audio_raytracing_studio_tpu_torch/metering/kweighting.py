"""ITU-R BS.1770-4 K-weighting prefilter design (pure NumPy, float64) — copy
of ``audio_raytracing_studio_tpu/metering/kweighting.py``.

Two biquads: a +4 dB high-frequency shelf modelling head acoustics, and a
high-pass (RLB) weighting.  Coefficients are designed for arbitrary sample
rates from the analog prototype parameters using the De Man
parameterization — the variant that reproduces the coefficient table
printed in BS.1770-4 exactly at fs=48 kHz (pyloudnorm ships it as its
opt-in ``filter_class="DeMan"``; its *default* cookbook shelf, which the
reference uses via ``pyloudnorm.Meter(rate)`` at
raytracer_studio.py:685-691, deviates from the table by
~0.01 LU — this design is the more standard-conformant of the two).

The port's meter (``metering.loudness``) turns the two biquads into one FIR
(their impulse response, by scipy.lfilter) and takes the gating-block
constants and ``block_count`` from here.
"""

from __future__ import annotations

import math

import numpy as np

# Analog prototype parameters (BS.1770 / pyloudnorm).
SHELF_GAIN_DB = 3.999843853973347
SHELF_FC_HZ = 1681.974450955533
SHELF_Q = 0.7071752369554196

HIGHPASS_FC_HZ = 38.13547087602444
HIGHPASS_Q = 0.5003270373238773

# Loudness measurement constants.
BLOCK_SECONDS = 0.4  # gating block size T_g
BLOCK_OVERLAP = 0.75
ABSOLUTE_GATE_LUFS = -70.0
RELATIVE_GATE_LU = -10.0
LOUDNESS_OFFSET = -0.691


def channel_weights(num_channels: int) -> np.ndarray:
    """BS.1770-4 G weights for THIS repo's channel orders
    (config.CHANNEL_LAYOUTS: FL FR C LFE RL RR [SL SR | TFL TFR]): the LFE
    channel (index 3) is excluded from the measurement entirely, and
    rear/side/height channels weigh +1.5 dB (1.41).

    The layout assumption only holds for the repo's own channel counts
    (6 = 5.1, 8 = 7.1 / 5.1.2).  Arbitrary input files with other counts
    (quad, 5.0, …) carry no LFE at index 3 — silencing a rear channel or
    boosting the wrong ones there misreads LUFS by several dB, so unknown
    counts weigh every channel 1.0 (the BS.1770 default for unlabelled
    channels)."""
    w = np.ones(num_channels, dtype=np.float64)
    if num_channels in (6, 8):
        w[3] = 0.0  # LFE
        w[4:] = 1.41
    return w


def high_shelf_coefficients(rate: float) -> tuple[np.ndarray, np.ndarray]:
    """Pre-filter shelf biquad (b, a), a0-normalized.

    Uses the De Man bilinear parameterization (the one that reproduces the
    BS.1770 coefficient table exactly at 48 kHz and generalizes it to any
    sample rate).
    """
    K = math.tan(math.pi * SHELF_FC_HZ / rate)
    Vh = 10.0 ** (SHELF_GAIN_DB / 20.0)
    Vb = Vh**0.4996667741545416

    denom = 1.0 + K / SHELF_Q + K * K
    b0 = (Vh + Vb * K / SHELF_Q + K * K) / denom
    b1 = 2.0 * (K * K - Vh) / denom
    b2 = (Vh - Vb * K / SHELF_Q + K * K) / denom
    a1 = 2.0 * (K * K - 1.0) / denom
    a2 = (1.0 - K / SHELF_Q + K * K) / denom

    b = np.array([b0, b1, b2], dtype=np.float64)
    a = np.array([1.0, a1, a2], dtype=np.float64)
    return b, a


def high_pass_coefficients(rate: float) -> tuple[np.ndarray, np.ndarray]:
    """RLB high-pass biquad (b, a), a0-normalized (De Man parameterization)."""
    K = math.tan(math.pi * HIGHPASS_FC_HZ / rate)

    denom = 1.0 + K / HIGHPASS_Q + K * K
    a1 = 2.0 * (K * K - 1.0) / denom
    a2 = (1.0 - K / HIGHPASS_Q + K * K) / denom

    b = np.array([1.0, -2.0, 1.0], dtype=np.float64)
    a = np.array([1.0, a1, a2], dtype=np.float64)
    return b, a


def k_weighting_coefficients(rate: float) -> list[tuple[np.ndarray, np.ndarray]]:
    """Both K-weighting stages, applied shelf-then-highpass."""
    return [high_shelf_coefficients(rate), high_pass_coefficients(rate)]


def block_count(num_samples: int, rate: float) -> int:
    """Number of 400 ms / 75%-overlap gating blocks (pyloudnorm's formula)."""
    T = num_samples / rate
    step = 1.0 - BLOCK_OVERLAP
    if T < BLOCK_SECONDS:
        return 0
    return int(round((T - BLOCK_SECONDS) / (BLOCK_SECONDS * step))) + 1
