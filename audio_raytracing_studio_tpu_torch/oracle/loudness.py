"""Float64 BS.1770-4 integrated loudness oracle (scipy.lfilter based).

Stands in for ``pyloudnorm.Meter`` which the reference uses at
raytracer_studio.py:685-691 (pyloudnorm is itself a BS.1770 implementation).
The port's own copy of ``audio_raytracing_studio_tpu/oracle/loudness.py``
(same code): the ``backend="oracle"`` arm of
``analysis.metrics.calculate_audio_metrics``; the device meter in
``metering.loudness`` is tested against it.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

from ..metering import kweighting as kw


def k_weight(signal: np.ndarray, rate: float) -> np.ndarray:
    """Apply the two-stage K-weighting prefilter along axis 0 (float64)."""
    out = np.asarray(signal, dtype=np.float64)
    for b, a in kw.k_weighting_coefficients(rate):
        out = lfilter(b, a, out, axis=0)
    return out


def integrated_loudness(data: np.ndarray, rate: float) -> float:
    """Gated integrated loudness (LUFS) of a mono or multi-channel signal.

    Channel weights follow BS.1770 (1.0 for the first three channels, 1.41
    for surrounds); the reference only ever meters a mono mixdown of the
    first ≤2 channels (raytracer_studio.py:687-688).
    """
    x = np.asarray(data, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, np.newaxis]
    num_samples, num_channels = x.shape
    if num_samples == 0:
        return float("-inf")

    weights = kw.channel_weights(num_channels)  # LFE excluded (BS.1770-4)

    filtered = k_weight(x, rate)

    T_g = kw.BLOCK_SECONDS
    step = 1.0 - kw.BLOCK_OVERLAP
    num_blocks = kw.block_count(num_samples, rate)
    if num_blocks <= 0:
        return float("-inf")

    # Per-block mean square z_ij, computed for every channel
    # (pyloudnorm convention: Σx² / (T_g·rate), slices clipped by numpy).
    z = np.zeros((num_channels, num_blocks))
    for j in range(num_blocks):
        lo = int(T_g * (j * step) * rate)
        hi = int(T_g * (j * step + 1) * rate)
        z[:, j] = np.sum(np.square(filtered[lo:hi, :]), axis=0) / (T_g * rate)

    with np.errstate(divide="ignore"):
        block_loudness = kw.LOUDNESS_OFFSET + 10.0 * np.log10(weights @ z)

    # Absolute gate at −70 LUFS.
    abs_gated = block_loudness >= kw.ABSOLUTE_GATE_LUFS
    if not np.any(abs_gated):
        return float("-inf")
    z_avg = np.mean(z[:, abs_gated], axis=1)
    with np.errstate(divide="ignore"):
        gamma_r = (
            kw.LOUDNESS_OFFSET + 10.0 * np.log10(weights @ z_avg) + kw.RELATIVE_GATE_LU
        )

    # Relative gate 10 LU below the abs-gated loudness.
    rel_gated = (block_loudness > gamma_r) & (block_loudness > kw.ABSOLUTE_GATE_LUFS)
    if not np.any(rel_gated):
        return float("-inf")
    z_avg = np.mean(z[:, rel_gated], axis=1)
    with np.errstate(divide="ignore"):
        return float(kw.LOUDNESS_OFFSET + 10.0 * np.log10(weights @ z_avg))


def calculate_audio_metrics(data: np.ndarray, rate: float) -> dict:
    """LUFS / sample-peak dBFS / RMS dBFS, reference conventions.

    Mirrors calculate_audio_metrics (raytracer_studio.py:674-711): LUFS over
    the mean of the first ≤2 channels; "true peak" is plain sample peak (the
    reference does not oversample despite the name); RMS over all channels.
    """
    metrics = {"lufs": None, "true_peak_dbfs": None, "rms_dbfs": None}
    if data is None or data.size == 0 or rate <= 0:
        return metrics
    x = np.asarray(data)
    if x.ndim == 1:
        x = x[:, np.newaxis]
    num_channels = x.shape[1]

    num_lufs_ch = min(num_channels, 2)
    data_lufs = x[:, 0] if num_lufs_ch == 1 else np.mean(x[:, :num_lufs_ch], axis=1)
    if np.max(np.abs(data_lufs)) < 1e-6:
        metrics["lufs"] = -np.inf
    else:
        metrics["lufs"] = integrated_loudness(data_lufs, rate)

    linear_peak = float(np.max(np.abs(x)))
    rms_linear = float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    metrics["true_peak_dbfs"] = (
        20 * np.log10(linear_peak) if linear_peak > 1e-15 else -np.inf
    )
    metrics["rms_dbfs"] = 20 * np.log10(rms_linear) if rms_linear > 1e-15 else -np.inf
    return metrics
