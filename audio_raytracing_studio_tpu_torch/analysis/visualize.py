"""Visualizer: per-channel waveforms + spectrogram PNG for a WAV file — port
of ``audio_raytracing_studio_tpu/analysis/visualize.py``.

Product parity with plot_waveform_and_spectrogram_v4
(raytracer_studio.py:573-672): layout detection by channel count, ≤4
waveform rows × 2 columns, symlog-frequency spectrogram of channel 0 with a
duration-adaptive FFT size and a [max(median−40, max−80), max] dB color
scale, error-PNG fallback.  Matplotlib stays on the host and is imported
inside ``plot_waveform_and_spectrogram`` (it may be absent beside the card);
the STFT can run on the device through ``torch.fft``.
"""

from __future__ import annotations

import os
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch

from .. import config
from ..utils import wavio
from ..utils.runtime import resolve_device


def detect_layout_names(channels: int) -> list[str]:
    """Channel names by count, falling back to Ch N (ref :592-594)."""
    for layout_info in config.CHANNEL_LAYOUTS.values():
        if layout_info["channels"] == channels:
            return list(layout_info["names"])
    return [f"Ch {i + 1}" for i in range(channels)]


def spectrogram_nperseg(duration: float) -> int:
    """Duration-adaptive FFT size (ref :626-628)."""
    if duration > 30:
        return 4096
    if duration > 5:
        return 2048
    return 1024


def stft_power(x: torch.Tensor, window: torch.Tensor, scale: float) -> torch.Tensor:
    """scipy-density STFT power of a 1-D float32 tensor → (frames, bins);
    ``window`` (nperseg,) lies on ``x``'s device.

    Half-overlapping frames are a strided view of ``x`` (``unfold``); each
    frame loses its mean (scipy's default ``detrend='constant'``), is
    weighted by the window, and ``|rfft|² · scale`` is doubled
    on every one-sided bin except DC — and except the last bin only when
    ``nperseg`` is even (an odd FFT size has no pure Nyquist bin; a short
    clip clamps ``nperseg`` to its odd length, where leaving the last bin
    undoubled would read it 3 dB low against scipy).
    """
    nperseg = window.shape[0]
    frames = x.unfold(0, nperseg, nperseg // 2)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    sx = torch.fft.rfft(frames * window, dim=-1).abs().square() * scale
    hi = -1 if nperseg % 2 == 0 else None
    sx[..., 1:hi] *= 2.0
    return sx


def compute_spectrogram(
    data: np.ndarray, rate: int, nperseg: int, use_device: bool = False, device=None
):
    """Hann spectrogram (f, t, Sxx).  ``use_device`` routes the STFT through
    ``stft_power`` on ``device`` (``None``: the process-wide default device);
    otherwise ``scipy.signal.spectrogram`` computes it on the host."""
    if use_device:
        dev = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(dev)
        # periodic Hann, scipy.signal.spectrogram's default window (the
        # symmetric variant has a ~0.1% different Σw²), rounded to float32
        # as the device sees it; scipy 'density' scaling |X|²/(fs·Σw²) with
        # the sum taken in float64 on the host
        win = torch.hann_window(nperseg, periodic=True, dtype=torch.float64).float()
        scale = 1.0 / (rate * float(win.double().square().sum()))
        sxx = stft_power(x, win.to(dev), scale)
        f = np.fft.rfftfreq(nperseg, 1.0 / rate)
        t = (np.arange(sxx.shape[0]) * (nperseg // 2) + nperseg / 2) / rate
        return f, t, sxx.T.cpu().numpy()
    from scipy.signal import spectrogram as scipy_spectrogram

    return scipy_spectrogram(
        data, fs=rate, nperseg=nperseg, noverlap=nperseg // 2, window="hann"
    )


def plot_waveform_and_spectrogram(
    file_path, title: str = "Audio", use_device_stft: bool = False
) -> Optional[str]:
    """Render the analysis PNG; returns its temp path (error-PNG on failure).

    With ``use_device_stft`` the process-wide default device is resolved
    first, outside the error contract: a CUDA default without a card raises
    instead of drawing an error text."""
    if use_device_stft:
        resolve_device(None)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    actual_path = getattr(file_path, "name", file_path)
    fig = None
    try:
        if not actual_path or not isinstance(actual_path, str) or not os.path.exists(actual_path):
            raise FileNotFoundError(f"Ungültiger Pfad '{actual_path}'")
        data_float, rate = wavio.read(actual_path)
        if data_float.size == 0:
            raise ValueError(f"Leere Audiodaten: {os.path.basename(actual_path)}")
        channels = data_float.shape[1]
        duration = data_float.shape[0] / rate if rate > 0 else 0

        plot_ch_names = detect_layout_names(channels)

        max_wf_rows = 4
        wf_rows = min(max_wf_rows, (channels + 1) // 2)
        total_rows = wf_rows + 1
        height_ratios = [1] * wf_rows + [max(2, wf_rows)]
        fig_height = 2.0 * total_rows + 1.0
        fig = plt.figure(figsize=(12, fig_height))
        gs = fig.add_gridspec(
            total_rows, 2, height_ratios=height_ratios, hspace=0.5, wspace=0.15
        )
        fig.suptitle(
            f"Audioanalyse: {title} - {os.path.basename(actual_path)} ({channels}-Kanal)",
            fontsize=14,
        )
        time_axis = (
            np.linspace(0, duration, num=data_float.shape[0])
            if rate > 0
            else np.arange(data_float.shape[0])
        )

        base_ax = None
        for i in range(channels):
            row, col = i // 2, i % 2
            if row >= wf_rows:
                break
            ax = fig.add_subplot(gs[row, col], sharex=base_ax)
            if base_ax is None:
                base_ax = ax
            ax.plot(time_axis, data_float[:, i], lw=1)
            ax.set_title(plot_ch_names[i], fontsize=9)
            ax.grid(True, linestyle=":", alpha=0.6)
            ax.set_ylim([-1.05, 1.05])
            ax.axhline(0, color="black", linewidth=0.5, alpha=0.5)
            if col == 0:
                ax.set_ylabel("Amplitude", fontsize="small")
            if row < wf_rows - 1:
                plt.setp(ax.get_xticklabels(), visible=False)

        spec_ax = fig.add_subplot(gs[wf_rows, :], sharex=base_ax)
        spec_data = data_float[:, 0]
        if spec_data.size > 0 and rate > 0:
            try:
                nperseg = min(spectrogram_nperseg(duration), spec_data.shape[0])
                if nperseg < 2:
                    raise ValueError("Signal zu kurz für Spektrogramm.")
                f, t, sxx = compute_spectrogram(
                    spec_data, rate, nperseg, use_device=use_device_stft
                )
                sxx_db = 10 * np.log10(np.maximum(sxx, 1e-10))
                median_db, max_db = np.median(sxx_db), np.max(sxx_db)
                vmin = max(median_db - 40, max_db - 80)
                vmax = max_db
                if vmin >= vmax:
                    vmin = vmax - 10
                img = spec_ax.pcolormesh(
                    t, f, sxx_db, shading="auto", cmap="magma",
                    vmin=vmin, vmax=vmax, rasterized=True,
                )
                spec_ax.set_yscale("symlog", linthresh=100, linscale=0.5)
                spec_ax.set_ylim(bottom=20, top=rate / 2)
                cbar = fig.colorbar(img, ax=spec_ax, format="%+2.0f dB", pad=0.01, aspect=40)
                cbar.set_label("Intensität (dB)", size="small")
            except Exception as spe:  # noqa: BLE001 — plot must still save
                spec_ax.text(
                    0.5, 0.5, f"Spektrogramm Fehler:\n{type(spe).__name__}",
                    ha="center", va="center", color="orange", transform=spec_ax.transAxes,
                )
            spec_ax.set_title(f"Spektrogramm ({plot_ch_names[0]})", fontsize=12)
            spec_ax.set_ylabel("Frequenz (Hz)")
            spec_ax.set_xlabel("Zeit (s)")
        else:
            spec_ax.text(
                0.5, 0.5, "Keine Daten für Spektrogramm.",
                ha="center", va="center", transform=spec_ax.transAxes,
            )

        plt.tight_layout(rect=[0, 0.03, 1, 0.96])
        with tempfile.NamedTemporaryFile(delete=False, suffix=".png", prefix="vis_v4_") as tmp:
            plot_path = tmp.name
        plt.savefig(plot_path, dpi=120)
        return plot_path
    except Exception as e:  # noqa: BLE001 — error-PNG fallback (ref :659-669)
        traceback.print_exc()
        try:
            err_fig, err_ax = plt.subplots(1, 1, figsize=(10, 3))
            err_ax.text(
                0.5, 0.5, f"Fehler beim Plotten:\n{type(e).__name__}: {str(e)[:100]}",
                ha="center", va="center", color="red", fontsize=9, wrap=True,
            )
            err_ax.set_axis_off()
            with tempfile.NamedTemporaryFile(delete=False, suffix=".png", prefix="vis_err_") as tmp:
                error_path = tmp.name
            err_fig.savefig(error_path)
            plt.close(err_fig)
            return error_path
        except Exception:  # noqa: BLE001
            return None
    finally:
        if fig is not None:
            plt.close(fig)
