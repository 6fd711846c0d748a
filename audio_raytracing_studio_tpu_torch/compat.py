"""Reference-API compatibility façade — the raytracer_studio.py surface.

Every public function and module-level constant of the reference monolith
(raytracer_studio.py), exposed under the reference's exact name and signature
so call sites migrate 1:1:

    from audio_raytracing_studio_tpu_torch import compat as raytracer_studio

Port of ``audio_raytracing_studio_tpu/compat.py``.  The implementations
delegate to the port: hot DSP routes through the same device ops the
pipeline uses (``ops.filters``, ``ops.convolution``, ``ops.spatial``,
``ops.ir_synth.synthesize``) as plain functions on tensors — nothing is
compiled per shape, so no static spec keys a cache here; host-level utilities
(presets, marker, metrics, plots, UI handlers) route through the package's
modules.  Numeric outputs match the reference within the project parity
contract (≤1e-3 max-abs; see PARITY.md).

Three deliberate, documented deviations:

* ``generate_impulse_response_split_3d`` takes an optional ``seed`` keyword
  (default 0).  The reference uses the **unseeded global NumPy RNG**
  (raytracer_studio.py:262-285), so even the reference cannot reproduce its
  own output run-to-run; here randomness is the framework's counter-based
  hash stream (ops/rng.py, PARITY.md "seed streams v2") — deterministic per
  seed and identical across the plain and CUDA-kernel backends.
* DSP functions take an optional ``backend`` keyword: ``"torch"`` (default)
  runs the device path on ``device`` (a keyword beside it; ``None`` is the
  process-wide ``utils.runtime.default_device()``, CUDA unless told
  otherwise, and CUDA without a card raises); ``"oracle"`` runs the float64
  NumPy reference-semantics implementation (oracle/dsp.py) on the host — the
  same switch analysis.metrics.calculate_audio_metrics exposes.
* ``generate_impulse_response_split_3d`` honors at most **80 early
  reflections** (``ops.ir_synth.MAX_REFLECTIONS`` — the static tap budget
  of the bank kernels, and the reference's own product-path clip at
  raytracer_studio.py:224).  The bare reference function would loop an
  arbitrary ``reflection_count``; here counts above 80 are capped on both
  backends (consistently, so parity between them holds).

UI-handler functions that the reference defines over gradio types
(``gr.update`` / ``gr.SelectData``) return objects from the same ``gr``
layer the studio uses: real gradio when installed, else the in-repo
API-compatible headless runtime (app/_gradio_headless.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import config, params
from .analysis import metrics as _metrics
from .analysis.profiler import run_audio_profiler as _run_audio_profiler
from .analysis.visualize import (
    plot_waveform_and_spectrogram as _plot_waveform_and_spectrogram,
)
from .app import marker as _marker
from .app import studio as _studio
from .app.api import (  # noqa: F401  (re-exports: ref :991-1125, :1129-1174)
    apply_raytrace_convolution_3d,
    process_audio_main_v41,
)
from .models import pipeline as _pipeline
from .ops import convolution as _convolution
from .ops import filters as _filters
from .ops import ir_synth as _ir_synth
from .ops import spatial as _spatial
from .oracle import dsp as _oracle
from .params import IRDraws, RenderParams  # noqa: F401
from .utils.presets import PresetStore
from .utils.runtime import resolve_device as _resolve_device

# --- module-level constants (ref raytracer_studio.py:22-43) ---------------
APP_VERSION = config.APP_VERSION
PRESET_DIR = config.PRESET_DIR
LAST_PRESET_FILE = os.path.join(config.PRESET_DIR, config.LAST_PRESET_FILENAME)
BASE_SURROUND_MAP_PATH = config.BASE_SURROUND_MAP_PATH
material_absorption = config.MATERIAL_ABSORPTION
DEFAULT_MATERIAL = config.DEFAULT_MATERIAL
DEFAULT_HALL_TYPE = config.DEFAULT_HALL_TYPE
CHANNEL_LAYOUTS = config.CHANNEL_LAYOUTS
DEFAULT_CHANNEL_LAYOUT = config.DEFAULT_CHANNEL_LAYOUT


def _store() -> PresetStore:
    """Preset store rooted at the CWD, like the reference's relative paths."""
    return PresetStore(".")


# --- presets (ref :47-80, :864-988) ----------------------------------------


def ensure_preset_dir():
    """Create PRESET_DIR if missing (ref :47-49)."""
    _store().ensure_dir()


def save_last_preset(preset_name):
    """Persist the last-used preset filename (ref :51-60)."""
    _store().save_last(preset_name)


def load_last_preset():
    """Last-used preset filename, or None (ref :62-80)."""
    return _store().load_last()


def list_presets_for_dropdown_v4():
    """Sorted case-insensitive ``*_v4.json`` listing (ref :864-868)."""
    return _store().list_presets()


def save_current_preset_v4(preset_name, *control_values):
    """Save the 16 control values → (status message, dropdown update)
    (ref :870-899)."""
    return _studio.save_preset(_store(), preset_name, *control_values)


def load_selected_preset_v4(preset_file):
    """Load a preset → 16 control updates in v4 key order (ref :901-932)."""
    return _studio.load_preset(_store(), preset_file)


def delete_selected_preset_v4(preset_file):
    """Delete a preset → (status message, dropdown update) (ref :934-946)."""
    return _studio.delete_preset(_store(), preset_file)


def export_presets_as_zip_v4():
    """ZIP all presets to a temp file → its path, or None (ref :948-988)."""
    return _store().export_zip()


# --- parameter math (ref :147-236) ------------------------------------------


def update_hall_info(selected_hall_type):
    """Hall-description markdown (ref :147-155)."""
    return _studio.update_hall_info(selected_hall_type)


def adjust_reverb_parameters_by_hall(hall_type):
    """(ir_duration_s, reflection_count, max_early_delay_s, early_late_split_s)
    per hall type (ref :157-166)."""
    hp = params.hall_base_parameters(hall_type)
    return (
        hp.ir_duration_s,
        hp.reflection_count,
        hp.max_early_delay_s,
        hp.early_late_split_s,
    )


# exact reference names and semantics already live in params.py
from .params import (  # noqa: E402,F401  (ref :168-236)
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
)


# --- device helpers -----------------------------------------------------------
# Plain functions on (1, C, N) tensors: the batch dim the port's ops carry is
# added here and dropped on the way back to the reference's (N, C) arrays.


def _up(array_nc: np.ndarray, dev) -> torch.Tensor:
    """(N, C) host array → (1, C, N) float32 tensor on ``dev``."""
    # a fresh C-ordered copy: the caller's array may be read-only or a view
    x = np.array(np.asarray(array_nc, dtype=np.float32).T, order="C")
    return _ir_synth.to_device(x, dev)[None]


def _down(x_bcn: torch.Tensor) -> np.ndarray:
    """(1, C, N) tensor → (N, C) host array."""
    return x_bcn[0].cpu().numpy().T


def _scalar(value, dev) -> torch.Tensor:
    """One host scalar → a (1,) float32 tensor on ``dev``."""
    return _ir_synth.to_device(np.asarray([value], dtype=np.float32), dev)


def _mix_eq_normalize(audio, wet, dry_wet, kill_start_dw, bass_gain, treble_gain, rate):
    """Dry-kill mix → shelf EQ (skipped at unity, ref :389) → conditional
    normalize: the shared tail of both convolve functions.  ``audio`` is
    (1, 2, n_in), ``wet`` (1, 2, len_out)."""
    dev = audio.device
    dw = float(np.clip(dry_wet, 0.0, 1.0))
    dry_factor = params.dry_kill_factor(dw, float(np.clip(kill_start_dw, 0.0, 1.0)))
    dry = torch.nn.functional.pad(audio, (0, wet.shape[-1] - audio.shape[-1]))
    dry_coef = _scalar(np.float32(dry_factor) * (np.float32(1.0) - np.float32(dw)), dev)
    mixed = dry_coef[:, None, None] * dry + _scalar(dw, dev)[:, None, None] * wet
    if params.eq_enabled(bass_gain, treble_gain):
        mixed = _filters.apply_shelf_eq(
            mixed, int(rate), _scalar(bass_gain, dev), _scalar(treble_gain, dev)
        )
    return _filters.conditional_peak_normalize(mixed)


# --- DSP core (ref :84-571) --------------------------------------------------


def generate_impulse_response_split_3d(
    rate, ir_duration, reflection_count, max_delay, material,
    directionality, early_late_split, diffusion_grade,
    *, seed: int = 0, backend: str = "torch", device=None,
):
    """Split (early_ir, late_ir) float32 arrays (ref :238-308).

    Deterministic per ``seed`` (see module docstring); both backends consume
    the same counter-based draw stream, so they agree within float error.
    """
    g = params.derive_ir_geometry(
        rate, ir_duration, reflection_count, max_delay,
        material, directionality, early_late_split, diffusion_grade,
    )
    if g.rate <= 0 or g.ir_duration <= 0:
        # the reference's degenerate fallback: unit early impulse, silent late
        return np.array([1.0], dtype=np.float32), np.zeros(1, dtype=np.float32)
    shape = _ir_synth.IRShape.from_geometry(g)
    if backend == "oracle":
        # the hash stream draws the full static tap budget; the oracle takes
        # exactly reflection_count taps and late_length noise samples
        delays, strengths, noise = _ir_synth.hash_draws(int(seed), shape)
        n = max(0, shape.reflection_count)
        draws = IRDraws(
            delays=delays.numpy()[:n],
            strengths=strengths.numpy()[:n],
            noise=noise.numpy()[: max(0, g.late_length)],
        )
        return _oracle.generate_impulse_response_split(g, draws)
    dev = _resolve_device(device)
    delays, strengths, noise = _ir_synth.hash_draws(int(seed), shape, device=dev)
    early, late = _ir_synth.synthesize(
        shape, delays, strengths, noise, _ir_synth.IRScalars.from_geometry(g)
    )
    return early.cpu().numpy(), late.cpu().numpy()


def apply_simple_lp_filter(signal, rate, air_absorption_factor, *, backend="torch",
                           device=None):
    """FFT-domain air-absorption low-pass over all channels (ref :310-336).

    Returns the input unchanged when the factor is below the skip threshold
    or the input is not a non-empty 2-D array (the reference's guards).
    """
    if air_absorption_factor < config.AIR_ABSORPTION_MIN_FACTOR:
        return signal
    if not isinstance(signal, np.ndarray) or signal.ndim != 2 or signal.size == 0:
        return signal
    if signal.shape[0] < 2:
        return signal
    if backend == "oracle":
        return _oracle.apply_air_absorption(signal, rate, air_absorption_factor)
    dev = _resolve_device(device)
    out = _filters.apply_air_absorption(
        _up(signal, dev), int(rate), _scalar(np.clip(air_absorption_factor, 0.0, 1.0), dev)
    )
    return _down(out)


def dynamic_dry_wet_mix(dry_signal, wet_signal, dry_wet, kill_start=0.5):
    """Dry/wet crossfade with linear dry-kill past ``kill_start`` and
    tail-append length handling (ref :84-144).  Elementwise host math — the
    ONE implementation lives in oracle/dsp.py (shares params.dry_kill_factor
    with the device pipeline)."""
    return _oracle.dynamic_dry_wet_mix(dry_signal, wet_signal, dry_wet, kill_start)


def convolve_audio_split_3d(
    data, early_ir, late_ir, early_level, late_level, dry_wet,
    bass_gain=1.0, treble_gain=1.0, rate=44100, kill_start_dw=0.5,
    air_absorption_factor=0.0, *, backend="torch", device=None,
):
    """Internal-hall wet path: early/late convolution + air LP on the late
    stream + dry-kill mix + shelf EQ + conditional normalize (ref :338-408).

    Returns (len_out, 2) float32 where len_out = len(data) + len(IR) − 1.
    """
    if backend == "oracle":
        return _oracle.convolve_audio_split(
            data, early_ir, late_ir, early_level, late_level, dry_wet,
            bass_gain, treble_gain, rate, kill_start_dw, air_absorption_factor,
        )
    if data is None or np.asarray(data).size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    dev = _resolve_device(device)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(data))
    early = np.asarray(early_ir, dtype=np.float32).flatten()
    late = np.asarray(late_ir, dtype=np.float32).flatten()
    n_in = audio_nc.shape[0]

    # activity rules of the reference (size > 1, any nonzero, level > 1e-6);
    # an inactive stream enters with level 0
    early_act = early.size > 1 and bool(np.any(early)) and early_level > 1e-6
    late_act = late.size > 1 and bool(np.any(late)) and late_level > 1e-6
    l_pad = max(early.size, late.size, 1)
    kernels = np.zeros((2, l_pad), dtype=np.float32)
    kernels[0, : early.size] = early
    kernels[1, : late.size] = late
    len_out = max(n_in, n_in + l_pad - 1)

    audio = _up(audio_nc, dev)
    conv = _convolution.convolve_full(audio, _ir_synth.to_device(kernels, dev)[None], len_out)
    late_wet = conv[:, 1]
    if air_absorption_factor > config.AIR_ABSORPTION_MIN_FACTOR:
        late_wet = _filters.apply_air_absorption(
            late_wet, int(rate), _scalar(np.clip(air_absorption_factor, 0.0, 1.0), dev)
        )
    wet = (
        conv[:, 0] * _scalar(early_level if early_act else 0.0, dev)[:, None, None]
        + late_wet * _scalar(late_level if late_act else 0.0, dev)[:, None, None]
    )
    out = _mix_eq_normalize(audio, wet, dry_wet, kill_start_dw, bass_gain, treble_gain, rate)
    return _down(out)


def convolve_audio_external_ir(
    data, external_ir_data, dry_wet,
    bass_gain=1.0, treble_gain=1.0, rate=44100, kill_start_dw=0.5,
    *, backend="torch", device=None,
):
    """True-stereo convolution L⊛IR_L, R⊛IR_R + mix + EQ (ref :410-462).

    A non-stereo IR is rejected and the input returned unchanged (float32),
    matching the reference's logged skip."""
    if backend == "oracle":
        return _oracle.convolve_audio_external_ir(
            data, external_ir_data, dry_wet, bass_gain, treble_gain,
            rate, kill_start_dw,
        )
    if data is None or np.asarray(data).size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    ir = external_ir_data
    if (
        ir is None
        or not isinstance(ir, np.ndarray)
        or ir.ndim != 2
        or ir.shape[1] != 2
    ):
        return np.asarray(data, dtype=np.float32)
    dev = _resolve_device(device)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(data))
    n_in = audio_nc.shape[0]
    len_out = max(n_in, n_in + int(ir.shape[0]) - 1)
    audio = _up(audio_nc, dev)
    wet = _convolution.convolve_pairwise(audio, _up(ir, dev)[0], len_out)
    out = _mix_eq_normalize(audio, wet, dry_wet, kill_start_dw, bass_gain, treble_gain, rate)
    return _down(out)


def apply_surround_panning_3d(audio_data, x_pos, y_pos, z_pos, *, backend="torch",
                              device=None):
    """Stereo → 5.1 constant-power pan, normalized only on clipping
    (ref :464-505).  Returns (N, 6) float32."""
    if backend == "oracle":
        return _oracle.apply_surround_panning(audio_data, x_pos, y_pos, z_pos)
    if audio_data is None or np.asarray(audio_data).size == 0:
        return np.zeros((0, 6), dtype=np.float32)
    dev = _resolve_device(device)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(audio_data))
    matrix = _spatial.pan_matrix(
        _scalar(np.clip(x_pos, 0.0, 1.0), dev),
        _scalar(np.clip(y_pos, 0.0, 1.0), dev),
        _scalar(np.clip(z_pos, 0.0, 1.0), dev),
    )
    six = _spatial.apply_pan(_up(audio_nc, dev), matrix)
    return _down(_filters.conditional_peak_normalize(six))


def apply_delay(signal, delay_samples):
    """Zero-pad front, trim tail to the original length (ref :507-515)."""
    if not isinstance(signal, np.ndarray):
        return signal
    return _oracle.apply_delay(signal, delay_samples)


def map_channels(data_5_1, target_layout_name, rate, z_pos=0.5, *, backend="torch",
                 device=None):
    """Map internal 5.1 onto the target layout → (array, channel names)
    (ref :517-571): stereo downmix, identity 5.1, delayed side channels for
    7.1, z-scaled delayed height channels for 5.1.2."""
    if backend == "oracle":
        return _oracle.map_channels(data_5_1, target_layout_name, rate, z_pos)
    if target_layout_name not in config.CHANNEL_LAYOUTS:
        target_layout_name = config.DEFAULT_CHANNEL_LAYOUT
    names = _spatial.layout_channel_names(target_layout_name)
    arr = np.asarray(data_5_1) if data_5_1 is not None else None
    if arr is None or arr.ndim != 2 or arr.shape[1] != 6:
        channels = config.CHANNEL_LAYOUTS[target_layout_name]["channels"]
        return np.zeros((0, channels), dtype=np.float32), names
    dev = _resolve_device(device)
    out = _spatial.map_layout(
        _up(arr, dev), target_layout_name, int(rate), _scalar(np.clip(z_pos, 0.0, 1.0), dev)
    )
    return _down(_filters.conditional_peak_normalize(out)), names


# --- analysis & metering (ref :573-813) -------------------------------------


def calculate_audio_metrics(data, rate, *, backend="torch", device=None):
    """{'lufs', 'true_peak_dbfs', 'rms_dbfs'} of (samples, channels) audio
    (ref :674-711): LUFS over the mean of the first ≤2 channels, sample-peak
    dBFS, RMS dBFS, −inf for silence, None on invalid input."""
    none_metrics = {"lufs": None, "true_peak_dbfs": None, "rms_dbfs": None}
    if (
        data is None
        or not isinstance(data, np.ndarray)
        or data.size == 0
        or rate <= 0
        or data.ndim not in (1, 2)
    ):
        return none_metrics
    return _metrics.calculate_audio_metrics(data, rate, device=device, backend=backend)


def plot_waveform_and_spectrogram_v4(file_path, title="Audio"):
    """Waveform grid + symlog spectrogram PNG → temp path (ref :573-672)."""
    return _plot_waveform_and_spectrogram(file_path, title)


def run_audio_profiler_v4(original_file_obj, processed_file_obj):
    """Markdown A/B comparison report (ref :713-813)."""
    return _run_audio_profiler(original_file_obj, processed_file_obj)


# --- UI handlers (ref :817-862, :1293-1384) ----------------------------------
# These return objects from the same `gr` layer the studio runs on (real
# gradio when installed, the in-repo headless runtime otherwise).


def update_marker_image(x_pos, y_pos, base_image_path_param=None):
    """Draw the red position marker → temp PNG path (ref :817-839)."""
    return _marker.update_marker_image(x_pos, y_pos, base_image_path_param)


def update_controls_from_click(evt):
    """Map click event → (x-slider, y-slider, marker image) updates
    (ref :841-854)."""
    return _studio.on_map_click(evt)


def handle_slider_change(x_pos, y_pos):
    """X/Y slider move → marker image update (ref :856-862)."""
    return _studio.on_slider_change(x_pos, y_pos)


def toggle_ir_controls_v4(use_external):
    """Interactivity updates for [external IR input] + the 7 hall controls
    (ref :1293-1303)."""
    return _studio.toggle_ir_controls(use_external)


def on_start_v41():
    """Startup initializer → the 28 ordered updates (ref :1333-1384)."""
    return _studio.on_start(_store())


__all__ = [
    # constants
    "APP_VERSION", "PRESET_DIR", "LAST_PRESET_FILE", "BASE_SURROUND_MAP_PATH",
    "material_absorption", "DEFAULT_MATERIAL", "DEFAULT_HALL_TYPE",
    "CHANNEL_LAYOUTS", "DEFAULT_CHANNEL_LAYOUT",
    # presets
    "ensure_preset_dir", "save_last_preset", "load_last_preset",
    "list_presets_for_dropdown_v4", "save_current_preset_v4",
    "load_selected_preset_v4", "delete_selected_preset_v4",
    "export_presets_as_zip_v4",
    # parameter math
    "update_hall_info", "adjust_reverb_parameters_by_hall",
    "adjust_parameters_for_3d", "compute_final_directionality_3d",
    "adapt_early_late_levels",
    # DSP core
    "generate_impulse_response_split_3d", "apply_simple_lp_filter",
    "dynamic_dry_wet_mix", "convolve_audio_split_3d",
    "convolve_audio_external_ir", "apply_surround_panning_3d",
    "apply_delay", "map_channels",
    # analysis
    "calculate_audio_metrics", "plot_waveform_and_spectrogram_v4",
    "run_audio_profiler_v4",
    # orchestrator + UI
    "apply_raytrace_convolution_3d", "process_audio_main_v41",
    "update_marker_image", "update_controls_from_click",
    "handle_slider_change", "toggle_ir_controls_v4", "on_start_v41",
]
