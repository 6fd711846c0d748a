"""Audio profiler: original-vs-processed A/B markdown report — port of
``audio_raytracing_studio_tpu/analysis/profiler.py``.

Product parity with run_audio_profiler_v4 (raytracer_studio.py:713-813):
loudness/peak/RMS deltas, side-signal stereo-width comparison, per-channel
RMS table with LFE callout, prose summary — same report structure and German
labels, metered by the port's meter on the process-wide default device
(``backend="torch"``) or by the float64 NumPy meter (``backend="oracle"``).
Everything but the meter is host code.
"""

from __future__ import annotations

import os
import numpy as np

from .. import config
from ..utils import wavio
from .metrics import calculate_audio_metrics
from .visualize import detect_layout_names


def stereo_width_metric(left: np.ndarray, right: np.ndarray) -> float:
    """RMS of the side signal (L−R)/2 (ref :769-773)."""
    if left.size != right.size or left.size == 0:
        return 0.0
    side = (left - right) * 0.5
    return float(np.sqrt(np.mean(np.square(side, dtype=np.float64))))


def _fmt_met(v, unit, digits=1) -> str:
    if v is None or (isinstance(v, float) and np.isinf(v) and v > 0):
        return "N/A"
    if isinstance(v, float) and np.isinf(v):
        return f"-inf {unit}"
    return f"{v:.{digits}f} {unit}"


def _fmt_diff(vp, vo, unit, digits=1) -> str:
    if vp is None or vo is None or np.isinf(vp) or np.isinf(vo):
        return "N/A"
    return f"{vp - vo:+.{digits}f} {unit}"


def run_audio_profiler(
    original_file, processed_file, backend: str = "torch"
) -> str:
    """Build the markdown comparison report (ref :713-813)."""
    report = [f"## 📊 Audio-Profiler Bericht ({config.APP_VERSION})"]

    original_path = getattr(original_file, "name", original_file)
    processed_path = getattr(processed_file, "name", processed_file)
    if not original_path or not os.path.exists(original_path):
        return "\n".join(report + ["\n**Fehler:** Originaldatei fehlt."])
    if not processed_path or not os.path.exists(processed_path):
        return "\n".join(report + ["\n**Fehler:** Bearbeitete Datei fehlt."])

    try:
        data_orig, rate_orig = wavio.read(original_path)
        data_proc, rate_proc = wavio.read(processed_path)
    except Exception as e:  # noqa: BLE001
        return "\n".join(report + [f"\n**Ladefehler:**\n```\n{e}\n```"])

    if rate_orig != rate_proc:
        return "\n".join(
            report
            + [f"\n**Fehler:** Sample-Raten unterschiedlich ({rate_orig} vs {rate_proc})."]
        )
    rate = rate_orig
    ch_orig, ch_proc = data_orig.shape[1], data_proc.shape[1]
    # a WAV may declare rate 0 — the reference degrades to duration 0
    # instead of dividing by zero (raytracer_studio.py duration guard)
    dur_orig = data_orig.shape[0] / rate if rate > 0 else 0.0
    dur_proc = data_proc.shape[0] / rate if rate > 0 else 0.0
    proc_names = detect_layout_names(ch_proc)

    m_orig = calculate_audio_metrics(data_orig, rate, backend=backend)
    m_proc = calculate_audio_metrics(data_proc, rate, backend=backend)

    report.append("\n### 📋 Basis-Infos")
    report.append(
        f"- **Original:** {ch_orig} Kanal{'e' if ch_orig != 1 else ''}, "
        f"{dur_orig:.2f}s @ {rate} Hz"
    )
    report.append(
        f"- **Bearbeitet:** {ch_proc} Kanal{'e' if ch_proc != 1 else ''} "
        f"({', '.join(proc_names)}), {dur_proc:.2f}s @ {rate} Hz"
    )
    report.append("\n### 🔊 Lautheit & Pegel")
    report.append("| Metrik          | Original              | Bearbeitet            | Änderung      |")
    report.append("|-----------------|-----------------------|-----------------------|---------------|")

    rows = [
        ("Integrated LUFS", "lufs", "LUFS", "LU", 2),
        ("True Peak", "true_peak_dbfs", "dBFS", "dB", 1),
        ("RMS", "rms_dbfs", "dBFS", "dB", 1),
    ]
    for label, key, unit, diff_unit, digits in rows:
        o = _fmt_met(m_orig.get(key), unit, digits)
        p = _fmt_met(m_proc.get(key), unit, digits)
        d = _fmt_diff(m_proc.get(key), m_orig.get(key), diff_unit, digits)
        report.append(f"| {label:<15} | {o:<21} | {p:<21} | {d:<13} |")

    # --- stereo width (ref :767-788) ---
    report.append("\n### ↔️ Stereo-Breite (FL/FR, Side RMS)")
    width_orig = (
        stereo_width_metric(data_orig[:, 0], data_orig[:, 1]) if ch_orig >= 2 else 0.0
    )
    width_proc = (
        stereo_width_metric(data_proc[:, 0], data_proc[:, 1]) if ch_proc >= 2 else 0.0
    )
    report.append(f"- Original: {width_orig:.4f}" if ch_orig >= 2 else "- Original: Mono/N/A")
    report.append(
        f"- Bearbeitet: {width_proc:.4f}" if ch_proc >= 2 else "- Bearbeitet: Mono/N/A"
    )
    if ch_orig >= 2 and ch_proc >= 2:
        if width_orig > 1e-9:
            width_change = f"{((width_proc / width_orig) - 1) * 100:+.1f}%"
        else:
            width_change = "Änderung von Stille" if width_proc > 1e-9 else "Bleibt Stille"
    elif ch_proc >= 2:
        width_change = "Mono -> Stereo"
    elif ch_orig >= 2:
        width_change = "Stereo -> Mono"
    else:
        width_change = "Beide Mono oder <2 Kanäle"
    report.append(f"- **Änderung:** {width_change}")

    # --- per-channel RMS (ref :790-801) ---
    report.append("\n### 🔊 Kanalpegel (Bearbeitet, RMS dBFS)")
    lfe_level = -np.inf
    if ch_proc > 0 and data_proc.size > 0:
        report.append("| Kanal     | RMS Pegel |")
        report.append("|-----------|-----------|")
        for i in range(ch_proc):
            ch = data_proc[:, i]
            rms = float(np.sqrt(np.mean(np.square(ch, dtype=np.float64))))
            dbfs = 20 * np.log10(rms) if rms > 1e-15 else -np.inf
            report.append(f"| {proc_names[i]:<9} | {_fmt_met(dbfs, 'dBFS', 1):<9} |")
            if i == 3 and proc_names[i] == "LFE":
                lfe_level = dbfs
        if not np.isinf(lfe_level):
            report.append(
                f"\n*Hinweis: LFE-Pegel ({_fmt_met(lfe_level, 'dBFS', 1)}) ist "
                "typischerweise niedriger.*"
            )
    else:
        report.append("- Keine Kanäle oder leere Daten in bearbeiteter Datei.")

    # --- summary (ref :803-810) ---
    report.append("\n### 📜 Zusammenfassung")
    changes = []
    lufs_diff = _fmt_diff(m_proc.get("lufs"), m_orig.get("lufs"), "LU", 2)
    if lufs_diff != "N/A":
        changes.append(f"Lautheitsänderung ({lufs_diff})")
    if width_change not in ("N/A", "Beide Mono oder <2 Kanäle", "Bleibt Stille"):
        changes.append(f"Stereobreite ({width_change})")
    if not np.isinf(lfe_level) and lfe_level > -40:
        changes.append(f"LFE ({_fmt_met(lfe_level, 'dBFS', 0)})")
    summary = "Vergleich zeigt: "
    summary += ", ".join(changes) + "." if changes else "minimale Unterschiede oder nicht zutreffend."
    report.append(summary)

    return "\n".join(report)
