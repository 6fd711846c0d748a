"""User-facing metrics — port of ``audio_raytracing_studio_tpu/analysis/metrics.py``.

The reference's metrics string (raytracer_studio.py:1070-1075):
``"LUFS: {x:.2f} | Peak: {y:.1f} dBFS | RMS: {z:.1f} dBFS"`` with "N/A" for
missing LUFS and "-inf" for silent peak/RMS; and the metrics of a host
(samples, channels) array through the port's meter on ``device``, or through
the float64 NumPy meter (``backend="oracle"``, ``oracle.loudness``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..metering import loudness
from ..utils.runtime import resolve_device


def metrics_string(metrics: dict) -> str:
    """Render the metrics dict exactly like the reference UI string."""
    lufs = metrics.get("lufs")
    peak = metrics.get("true_peak_dbfs")
    rms = metrics.get("rms_dbfs")

    lufs_str = (
        f"{float(lufs):.2f}"
        if lufs is not None and not math.isinf(float(lufs))
        else "N/A"
    )
    peak_str = (
        f"{float(peak):.1f}"
        if peak is not None and not math.isinf(float(peak))
        else "-inf"
    )
    rms_str = (
        f"{float(rms):.1f}" if rms is not None and not math.isinf(float(rms)) else "-inf"
    )
    return f"LUFS: {lufs_str} | Peak: {peak_str} dBFS | RMS: {rms_str} dBFS"


def calculate_audio_metrics(data: np.ndarray, rate: int, device=None,
                            backend: str = "torch") -> dict:
    """LUFS / sample-peak / RMS of (samples, channels) audio.

    ``backend="torch"`` runs the port's meter
    (``metering.loudness.audio_metrics``) on ``device`` (``None``: the
    process-wide ``utils.runtime.default_device()``); ``backend="oracle"``
    runs the float64 NumPy meter (``oracle.loudness``) on the host and needs
    no device.

    >2-D, empty or rate ≤ 0 input gives the None-metrics dict, as the
    reference's error path does (raytracer_studio.py:674-711) — it never raises.
    """
    if backend == "oracle":
        from ..oracle.loudness import calculate_audio_metrics as oracle_metrics

        return oracle_metrics(data, rate)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (expected 'torch' or 'oracle')")
    dev = resolve_device(device)
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, np.newaxis]
    if x.ndim != 2 or x.size == 0 or rate <= 0:
        return {"lufs": None, "true_peak_dbfs": None, "rms_dbfs": None}
    m = loudness.audio_metrics(torch.from_numpy(np.ascontiguousarray(x.T)).to(dev), int(rate))
    return {k: float(v) for k, v in m.items()}
