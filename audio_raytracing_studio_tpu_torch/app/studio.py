"""Gradio web UI — the same 4-tab studio as the reference; port of
``audio_raytracing_studio_tpu/app/studio.py``.

Tab/control/event-graph parity with raytracer_studio.py:1177-1397: processing & 3D positioning tab (upload/mic, external IR, hall &
room accordion, mix & EQ accordion, clickable position map), visualizer &
profiler tab, preset editor tab, help tab; the same preset-control ordering,
`.then()` chains and the 28-output startup initializer; launches on
0.0.0.0:8861.

gradio is an optional dependency: without it the headless runtime
(app/_gradio_headless.py) carries the same wiring.  All compute routes
through app.api, on the process-wide default device (``utils.runtime``).
"""

from __future__ import annotations

import functools
import logging

from .. import config
from ..params import RenderParams
from ..utils.presets import PresetStore
from ..utils.runtime import resolve_device, set_default_device
from ..analysis.profiler import run_audio_profiler
from ..analysis.visualize import plot_waveform_and_spectrogram
from . import api, marker

log = logging.getLogger("ars_torch.studio")

try:
    import gradio as gr

    GRADIO_AVAILABLE = True
except ImportError:  # headless images: the executable in-repo UI runtime
    from . import _gradio_headless as gr

    GRADIO_AVAILABLE = False


# --- module-level event handlers -----------------------------------------
# The same callables serve build_demo's event graph and the reference-API
# façade (compat.py): handlers that touch the preset store take it as an
# explicit first argument and are bound with functools.partial below.


def update_hall_info(selected: str) -> str:
    """Hall-description markdown (ref :147-155)."""
    texts = config.HALL_INFO_TEXTS
    return (
        "ℹ️ **Beschreibung:** "
        f"{texts.get(selected, texts[config.DEFAULT_HALL_TYPE])}"
    )


def toggle_ir_controls(use_external):
    """Interactivity updates [external_ir_input] + 7 hall controls (ref :1293-1303)."""
    is_external = bool(use_external)
    internal_update = gr.update(interactive=not is_external)
    return (gr.update(interactive=is_external),) + (internal_update,) * 7


def on_map_click(evt: gr.SelectData):
    """Map click → (x-slider, y-slider, marker-image) updates (ref :841-854).

    The ``gr.SelectData`` annotation is LOAD-BEARING under real gradio: its
    event-data injection keys on the parameter's type hint (the headless
    runtime also accepts the parameter name ``evt``)."""
    if not evt or not getattr(evt, "index", None) or len(evt.index) < 2:
        return gr.update(), gr.update(), gr.update()
    norm = marker.click_to_normalized(evt.index[0], evt.index[1])
    if norm is None:
        return gr.update(), gr.update(), gr.update(value=None)
    x, y = norm
    path = marker.update_marker_image(x, y)
    return gr.update(value=x), gr.update(value=y), (
        gr.update(value=path) if path else gr.update()
    )


def on_slider_change(x, y):
    """X/Y slider move → marker-image update (ref :856-862)."""
    path = marker.update_marker_image(x, y)
    return gr.update(value=path) if path else gr.update()


def save_preset(store: PresetStore, name, *values):
    """Save the 16 control values as a v4 preset (ref :870-899)."""
    try:
        params = RenderParams.from_preset_dict(dict(zip(config.PRESET_KEYS, values)))
        msg, filename = store.save(name, params)
        return f"✅ {msg}", gr.update(choices=store.list_presets(), value=filename)
    except ValueError:
        return "⚠️ Ungültiger Preset-Name.", gr.update()
    except Exception as e:  # noqa: BLE001
        return f"❌ Fehler beim Speichern: {e}", gr.update()


def load_preset(store: PresetStore, preset_file):
    """Load a preset → 16 control-value updates in v4 key order (ref :901-932)."""
    if not preset_file:
        return [gr.update()] * len(config.PRESET_KEYS)
    try:
        p = store.load(preset_file)
        return [gr.update(value=getattr(p, k)) for k in config.PRESET_KEYS]
    except Exception as e:  # noqa: BLE001
        log.warning("preset load failed: %s", e)
        return [gr.update()] * len(config.PRESET_KEYS)


def delete_preset(store: PresetStore, preset_file):
    """Delete a preset → (status, dropdown update) (ref :934-946)."""
    if not preset_file:
        return "⚠️ Kein Preset zum Löschen gewählt!", gr.update()
    ok = store.delete(preset_file)
    msg = (
        f"🗑️ Preset '{preset_file}' gelöscht!"
        if ok
        else f"⚠️ Preset '{preset_file}' nicht gefunden."
    )
    return msg, gr.update(choices=store.list_presets(), value=None)


def on_start(store: PresetStore):
    """Startup initializer → the 28 ordered updates (ref :1333-1384)."""
    store.ensure_dir()
    marker.ensure_map_asset()
    available = store.list_presets()
    last = store.load_last()
    p = RenderParams()
    preset_to_select = None
    if last:
        try:
            p = store.load(last)
            preset_to_select = last
        except Exception:  # noqa: BLE001
            store.save_last("")
    marker_path = marker.update_marker_image(p.x_pos, p.y_pos)
    updates = [gr.update(choices=available, value=preset_to_select)]
    updates += [gr.update(value=getattr(p, k)) for k in config.PRESET_KEYS]
    updates.append(gr.update(value=config.BASE_SURROUND_MAP_PATH))
    updates.append(gr.update(value=marker_path))
    updates.append(gr.update(value=update_hall_info(p.hall_type)))
    updates.extend(list(toggle_ir_controls(p.use_external_ir)))
    updates.append(gr.update(value="Bereit. Bitte Audio laden."))
    return updates


def build_demo(store: PresetStore | None = None):
    """Construct the gr.Blocks app (parity layout with the reference UI).

    Works with real gradio when installed, else on the API-compatible
    headless runtime — same wiring either way.
    """
    store = store or PresetStore(".")

    theme = gr.themes.Soft(
        primary_hue=gr.themes.colors.cyan,
        secondary_hue=gr.themes.colors.blue,
        neutral_hue=gr.themes.colors.slate,
    )

    with gr.Blocks(theme=theme, title=f"Audio Raytracing Studio {config.APP_VERSION}") as demo:
        # --- Tab 1: processing & positioning ---
        with gr.Tab("🎶 Audio-Verarbeitung & Positionierung"):
            gr.Markdown(f"# 🎶 Audio Raytracing Studio {config.APP_VERSION} (PyTorch / CUDA)")
            with gr.Row():
                with gr.Column(scale=1):
                    audio_input = gr.Audio(label="🔊 Audio hochladen", type="filepath", show_download_button=False)
                    mic_input = gr.Audio(label="🎤 Mikrofonaufnahme", sources=["microphone"], type="filepath", show_download_button=False)
                    use_external_ir = gr.Checkbox(label="💡 Externe Stereo IR verwenden?", value=False, info="Überschreibt interne Hallgenerierung.")
                    external_ir_input = gr.File(label="📂 Externe IR-Datei (Stereo WAV)", file_types=[".wav"], interactive=False)
                with gr.Column(scale=1):
                    target_layout_dropdown = gr.Dropdown(choices=list(config.CHANNEL_LAYOUTS.keys()), value=config.DEFAULT_CHANNEL_LAYOUT, label="🎯 Ziel-Layout")
                    output_audio = gr.Audio(label="🎧 Ergebnis anhören", type="filepath", interactive=False)
                    output_metrics_display = gr.Textbox(label="📊 Ergebnis-Metriken (Gesamt)", value="Noch keine Verarbeitung.", interactive=False, lines=1)
                    download = gr.File(label="💾 Download Ergebnis", interactive=False)

            with gr.Accordion("⚙️ Raum & Hall Charakteristik (Interne Generierung)", open=True):
                with gr.Row():
                    with gr.Column(scale=1):
                        hall_type = gr.Dropdown(choices=list(config.HALL_PRESETS.keys()), label="🏛️ Hall-Typ", value=config.DEFAULT_HALL_TYPE, interactive=True)
                        material_choice = gr.Dropdown(choices=list(config.MATERIAL_ABSORPTION.keys()), value=config.DEFAULT_MATERIAL, label="🧱 Material", interactive=True)
                        hall_info_text = gr.Markdown(update_hall_info(config.DEFAULT_HALL_TYPE))
                    with gr.Column(scale=1):
                        room_size_slider = gr.Slider(10, 1000, value=100, step=10, label="📏 Raumgröße (m³)", interactive=True)
                        diffusion_slider = gr.Slider(0.0, 1.0, value=0.5, step=0.05, label="💫 Diffusion", interactive=True)
                        air_absorption_slider = gr.Slider(0.0, 1.0, value=0.1, step=0.05, label="💨 Luftabsorption", interactive=True)
                with gr.Row():
                    early_level = gr.Slider(0.0, 2.0, value=0.8, step=0.05, label="Basis Early Level", interactive=True)
                    late_level = gr.Slider(0.0, 2.0, value=0.6, step=0.05, label="Basis Late Level", interactive=True)

            with gr.Accordion("🔊 Mix & EQ", open=True):
                with gr.Row():
                    with gr.Column(scale=1):
                        dry_wet = gr.Slider(0.0, 1.0, value=0.5, step=0.01, label="Dry/Wet Mix")
                        dry_wet_kill_start_slider = gr.Slider(0.0, 1.0, value=0.5, step=0.05, label="Dry Kill Start")
                    with gr.Column(scale=1):
                        bass_gain = gr.Slider(0.1, 5.0, value=1.0, step=0.05, label="Bass Gain")
                        treble_gain = gr.Slider(0.1, 5.0, value=1.0, step=0.05, label="Treble Gain")

            with gr.Accordion("📍 3D Positionierung", open=True):
                with gr.Row():
                    with gr.Column(scale=2):
                        gr.Markdown("Klicke für X/Y Position")
                        surround_image = gr.Image(label="Karte (Klicken für X/Y)", value=config.BASE_SURROUND_MAP_PATH, interactive=True, type="filepath")
                        surround_output_image = gr.Image(label="🎯 Position (X/Y)", interactive=False, type="filepath")
                    with gr.Column(scale=1):
                        surround_x = gr.Slider(0.0, 1.0, value=0.5, step=0.01, label="↔️ X (L/R)")
                        surround_y = gr.Slider(0.0, 1.0, value=0.5, step=0.01, label="↕️ Y (F/B)")
                        surround_z = gr.Slider(0.0, 1.0, value=0.5, step=0.01, label="🔝 Z (U/O)")
            process_button = gr.Button("➡️ Verarbeiten & Anhören!", variant="primary")

        # --- Tab 2: visualizer & profiler ---
        with gr.Tab("📊 Visualizer & ⚖️ Profiler"):
            with gr.Row():
                with gr.Column(scale=1):
                    gr.Markdown("## 📊 Visualizer")
                    input_file_vis = gr.File(label="🔍 Original (Visualizer)", file_types=["audio"])
                    output_file_vis = gr.File(label="🔍 Bearbeitet (Visualizer)", file_types=["audio"])
                    with gr.Row():
                        load_last_result_vis = gr.Button("Lade letztes Ergebnis (Bearb.)", scale=1)
                        show_visuals_button = gr.Button("📊 Visualisieren", variant="secondary", scale=1)
                    input_image = gr.Image(label="🔵 Original Vis", interactive=False, type="filepath")
                    output_image = gr.Image(label="🟠 Bearbeitet Vis", interactive=False, type="filepath")
                with gr.Column(scale=1):
                    gr.Markdown("## ⚖️ Audio-Profiler")
                    profiler_input_original = gr.File(label="Lade Original (Profiler)", file_types=["audio"])
                    profiler_input_processed = gr.File(label="Lade Bearbeitet (Profiler)", file_types=["audio"])
                    with gr.Row():
                        load_last_result_prof = gr.Button("Lade letztes Ergebnis (Bearb.)", scale=1)
                        profiler_analyze_button = gr.Button("🚀 Analysieren!", variant="primary", scale=1)
                    profiler_report_output = gr.Markdown(label="📋 Analysebericht", value="*Bericht wird hier angezeigt...*")

        # --- Tab 3: preset editor ---
        with gr.Tab("🛠 Preset-Editor (v4)"):
            gr.Markdown("## 🛠 Presets (v4 Format)")
            with gr.Row():
                preset_name_input = gr.Textbox(label="📝 Preset-Name", placeholder="Name für neues Preset...")
                save_preset_button = gr.Button("💾 Speichern", variant="primary")
            save_status = gr.Label(label="Status", value="Bereit.")
            with gr.Row():
                preset_list = gr.Dropdown(label="📂 Presets (v4)", choices=[], interactive=True, allow_custom_value=False)
                with gr.Column(scale=1, min_width=160):
                    load_preset_button = gr.Button("📥 Laden")
                    refresh_presets_button = gr.Button("🔄 Liste neu laden")
                    delete_preset_button = gr.Button("🗑️ Löschen", variant="stop")
            with gr.Row():
                export_presets_button = gr.Button("📦 ZIP Export")
                zip_download = gr.File(label="📦 Download ZIP", interactive=False)

        # --- Tab 4: help ---
        with gr.Tab("ℹ️ Hilfe & Dokumentation"):
            gr.Markdown(
                f"""
                ## 🎶 Audio Raytracing Studio {config.APP_VERSION} — Hilfe
                PyTorch/CUDA-Portierung: identische Bedienung und Presets (v4), Rendering
                auf der GPU (IR-Synthese im CUDA-Kernel, FFT-Faltung über cuFFT,
                3D-Panning, Kanal-Mapping, BS.1770-Metering on-device).
                **Bedienung:** 1. Audio laden. 2. Modus wählen (Intern/Extern IR).
                3. Parameter anpassen. 4. Positionieren (X/Y/Z). 5. Ziel-Layout wählen.
                6. Verarbeiten. 7. Analyse (optional). 8. Presets (optional).
                **Technische Hinweise:** Ausgabe WAV (PCM16); Metriken: LUFS, Peak, RMS.
                """
            )

        # preset-controllable controls, in the v4 key order (ref :1282-1287)
        all_preset_controls = [
            use_external_ir, hall_type, material_choice, room_size_slider,
            diffusion_slider, air_absorption_slider, early_level, late_level,
            dry_wet, dry_wet_kill_start_slider, bass_gain, treble_gain,
            surround_x, surround_y, surround_z, target_layout_dropdown,
        ]

        # --- event handlers (module-level callables, see top of file) ---
        hall_type.change(fn=update_hall_info, inputs=[hall_type], outputs=[hall_info_text])

        interactive_outputs = [
            external_ir_input, hall_type, material_choice, room_size_slider,
            diffusion_slider, air_absorption_slider, early_level, late_level,
        ]
        use_external_ir.change(fn=toggle_ir_controls, inputs=[use_external_ir], outputs=interactive_outputs)

        surround_image.select(fn=on_map_click, inputs=None, outputs=[surround_x, surround_y, surround_output_image])
        surround_x.input(fn=on_slider_change, inputs=[surround_x, surround_y], outputs=[surround_output_image])
        surround_y.input(fn=on_slider_change, inputs=[surround_x, surround_y], outputs=[surround_output_image])

        show_visuals_button.click(fn=lambda f: plot_waveform_and_spectrogram(f, "Original"), inputs=[input_file_vis], outputs=[input_image])
        show_visuals_button.click(fn=lambda f: plot_waveform_and_spectrogram(f, "Bearbeitet"), inputs=[output_file_vis], outputs=[output_image])
        profiler_analyze_button.click(fn=run_audio_profiler, inputs=[profiler_input_original, profiler_input_processed], outputs=[profiler_report_output])
        load_last_result_vis.click(fn=lambda x: x, inputs=[download], outputs=[output_file_vis])
        load_last_result_prof.click(fn=lambda x: x, inputs=[download], outputs=[profiler_input_processed])

        # --- preset events ---
        save_preset_button.click(fn=functools.partial(save_preset, store), inputs=[preset_name_input] + all_preset_controls, outputs=[save_status, preset_list])
        load_preset_button.click(fn=functools.partial(load_preset, store), inputs=[preset_list], outputs=all_preset_controls
            ).then(fn=on_slider_change, inputs=[surround_x, surround_y], outputs=[surround_output_image]
            ).then(fn=update_hall_info, inputs=[hall_type], outputs=[hall_info_text]
            ).then(fn=toggle_ir_controls, inputs=[use_external_ir], outputs=interactive_outputs
            ).then(lambda p: f"Preset '{p}' geladen." if p else "Kein Preset gewählt.", inputs=[preset_list], outputs=save_status)
        refresh_presets_button.click(fn=lambda: gr.update(choices=store.list_presets()), inputs=[], outputs=[preset_list]
            ).then(lambda: "Presetliste aktualisiert.", inputs=None, outputs=save_status)
        delete_preset_button.click(fn=functools.partial(delete_preset, store), inputs=[preset_list], outputs=[save_status, preset_list])
        export_presets_button.click(fn=store.export_zip, inputs=[], outputs=[zip_download]
            ).then(lambda x: gr.update(value="ZIP Export erfolgreich." if x else "Export fehlgeschlagen."), inputs=[zip_download], outputs=save_status)

        process_button.click(
            fn=api.process_audio_main_v41,
            inputs=[audio_input, mic_input, external_ir_input] + all_preset_controls,
            outputs=[output_audio, download, output_metrics_display],
        )

        # --- startup initializer (ref :1333-1384) ---
        on_start_outputs = (
            [preset_list] + all_preset_controls
            + [surround_image, surround_output_image, hall_info_text]
            + interactive_outputs
            + [output_metrics_display]
        )
        demo.load(fn=functools.partial(on_start, store), inputs=[], outputs=on_start_outputs)

    return demo


def main(server_name: str = "0.0.0.0", server_port: int = config.DEFAULT_SERVER_PORT,
         device=None):
    """Launch the studio (reference launch config, raytracer_studio.py:1397).

    With gradio installed this serves the gradio app; without it, the
    package's own stdlib HTTP server (app/server.py) serves the same
    event graph on the same host:port — zero dependencies either way.

    ``device`` becomes the process-wide default of the handlers (``None``
    keeps it).  It is resolved before anything is created or bound: a CUDA
    default without a card raises here and no server starts.
    """
    if device is not None:
        set_default_device(device)
    resolve_device(None)
    store = PresetStore(".")
    store.ensure_dir()
    marker.ensure_map_asset()
    demo = build_demo(store)
    demo.launch(server_name=server_name, server_port=server_port, debug=True, share=False)


if __name__ == "__main__":
    from ..__main__ import main as _cli_main

    raise SystemExit(_cli_main())
