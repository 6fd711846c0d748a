"""Analyzer web UI — the sidecar tool's interface; port of
``audio_raytracing_studio_tpu/app/analyzer_ui.py``.

The reference ships a standalone Streamlit analyzer (analyser.py:108-157:
two modes — file analysis with LUFS + one-click −16 LUFS normalization, and
format conversion with selectable bitrate).  This is the same two-mode tool
on the port's meter, served with gradio when installed, else by the headless
runtime; the underlying capabilities live in cli.analyzer and run on the
process-wide default device (``utils.runtime.default_device()``).
"""

from __future__ import annotations

import json
import os

from ..cli import analyzer as core
from ..utils.runtime import resolve_device

try:
    import gradio as gr

    GRADIO_AVAILABLE = True
except ImportError:  # headless images: the executable in-repo UI runtime
    from . import _gradio_headless as gr

    GRADIO_AVAILABLE = False


def build_demo():
    def do_analyze(file):
        device = resolve_device(None)  # outside the error strings: may raise
        if file is None:
            return "Keine Datei."
        path = getattr(file, "name", file)
        try:
            return json.dumps(core.analyze(path, device=device), ensure_ascii=False, indent=2)
        except Exception as e:  # noqa: BLE001 — surfaced to the UI
            return f"Analyse fehlgeschlagen: {e}"

    def do_normalize(file, target):
        device = resolve_device(None)  # outside the error strings: may raise
        if file is None:
            return None, "Keine Datei."
        path = getattr(file, "name", file)
        import tempfile

        with tempfile.NamedTemporaryFile(delete=False, suffix="_normalized.wav") as tmp:
            out_path = tmp.name
        try:
            result = core.normalize_to_lufs(path, out_path, float(target), device=device)
        except Exception as e:  # noqa: BLE001 — e.g. silent clip: LUFS nicht messbar
            try:
                os.unlink(out_path)
            except OSError:
                pass
            return None, f"Normalisierung fehlgeschlagen: {e}"
        return out_path, json.dumps(result, indent=2)

    def do_convert(file, fmt, bitrate):
        device = resolve_device(None)  # outside the error strings: may raise
        if file is None:
            return None, "Keine Datei."
        path = getattr(file, "name", file)
        import tempfile

        with tempfile.NamedTemporaryFile(delete=False, suffix=f".{fmt}") as tmp:
            out_path = tmp.name
        try:
            core.convert(path, out_path, bitrate, device=device)
            return out_path, f"Konvertierung abgeschlossen: {out_path}"
        except Exception as e:  # noqa: BLE001 — surfaced to the UI
            try:
                os.unlink(out_path)
            except OSError:
                pass
            return None, f"Konvertierung fehlgeschlagen: {e}"

    with gr.Blocks(title="Audio Analyzer Studio") as demo:
        gr.Markdown("# 🎵 Audio Analyzer Studio")
        with gr.Tab("📃 Dateianalyse"):
            ana_file = gr.File(label="Audiodatei hochladen", file_types=["audio"])
            ana_button = gr.Button("Analysieren")
            ana_out = gr.Textbox(label="Analyse", lines=8)
            ana_button.click(do_analyze, [ana_file], [ana_out])
            gr.Markdown("### 🔊 LUFS-Normalisierung")
            target = gr.Slider(-36, -6, value=-16, step=1, label="Ziel-LUFS")
            norm_button = gr.Button("Auf Ziel-LUFS normalisieren")
            norm_file = gr.File(label="Normalisierte Datei")
            norm_report = gr.Textbox(label="Bericht", lines=5)
            norm_button.click(do_normalize, [ana_file, target], [norm_file, norm_report])
        with gr.Tab("🔄 Dateikonvertierung"):
            conv_file = gr.File(label="Audiodatei hochladen", file_types=["audio"])
            fmt = gr.Dropdown(["wav", "mp3", "flac", "aac", "ogg"], value="mp3", label="Zielformat")
            bitrate = gr.Dropdown(["64", "128", "192", "256", "320"], value="256", label="Bitrate (kbit/s)")
            conv_button = gr.Button("Konvertieren")
            conv_out = gr.File(label="Ergebnis")
            conv_status = gr.Textbox(label="Status")
            conv_button.click(do_convert, [conv_file, fmt, bitrate], [conv_out, conv_status])
    return demo


def main():
    # resolve the device before binding the port: a CUDA default without a
    # card raises here and no server starts
    resolve_device(None)
    build_demo().launch(server_name="0.0.0.0", server_port=8862)


if __name__ == "__main__":
    main()
