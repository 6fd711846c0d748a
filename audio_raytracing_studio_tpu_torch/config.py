"""Central configuration — copy of ``audio_raytracing_studio_tpu/config.py``.

Every DSP constant of the studio, typed and in one place.  The reference
scatters these inline (see raytracer_studio.py:22-43 for the tables and
:274, :320-326, :393, :485, :533, :542, :549 for the magic numbers).  These
numbers ARE the sound — they must match the JAX package's bit-exactly
(``tests/test_torch_config.py`` holds the two copies equal); the port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

APP_VERSION = "v4.1-tpu"
PRESET_DIR = "presets_v4"
LAST_PRESET_FILENAME = "last_preset_v4.txt"
BASE_SURROUND_MAP_PATH = "surround_layout_3d.png"
DEFAULT_SERVER_PORT = 8861  # reference raytracer_studio.py:1397

# --- Material absorption coefficients (raytracer_studio.py:29-33) ---
MATERIAL_ABSORPTION: Dict[str, float] = {
    "Stein": 0.15,
    "Holz": 0.35,
    "Teppich": 0.7,
    "Glas": 0.2,
    "Beton": 0.1,
    "Vorhang (schwer)": 0.8,
}
DEFAULT_MATERIAL = "Holz"
DEFAULT_HALL_TYPE = "Room"

# --- Channel layouts (raytracer_studio.py:37-43) ---
CHANNEL_LAYOUTS: Dict[str, Dict] = {
    "Stereo": {"channels": 2, "names": ["FL", "FR"]},
    "5.1 (Standard)": {"channels": 6, "names": ["FL", "FR", "C", "LFE", "RL", "RR"]},
    "7.1 (Surround)": {
        "channels": 8,
        "names": ["FL", "FR", "C", "LFE", "RL", "RR", "SL", "SR"],
    },
    "5.1.2 (Atmos Light)": {
        "channels": 8,
        "names": ["FL", "FR", "C", "LFE", "RL", "RR", "TFL", "TFR"],
    },
}
DEFAULT_CHANNEL_LAYOUT = "5.1 (Standard)"


# --- Hall-type base parameters (raytracer_studio.py:157-166) ---
@dataclasses.dataclass(frozen=True)
class HallPreset:
    """(ir_duration_s, reflection_count, max_early_delay_s, early_late_split_s)."""

    ir_duration_s: float
    reflection_count: int
    max_early_delay_s: float
    early_late_split_s: float


HALL_PRESETS: Dict[str, HallPreset] = {
    "Plate": HallPreset(0.8, 25, 0.025, 0.03),
    "Room": HallPreset(1.5, 35, 0.06, 0.08),
    "Cathedral": HallPreset(4.0, 20, 0.10, 0.12),
}

# Directionality base per hall type (raytracer_studio.py:197)
HALL_DIRECTIONALITY_BASE: Dict[str, float] = {
    "Plate": 0.95,
    "Room": 0.65,
    "Cathedral": 0.25,
}
HALL_DIRECTIONALITY_DEFAULT = 0.65

# Hall-description texts shown under the hall-type dropdown
# (raytracer_studio.py:147-155) — product strings, shared by the studio UI
# and the reference-API façade (compat.update_hall_info)
HALL_INFO_TEXTS: Dict[str, str] = {
    "Plate": "Klassischer Studioplate-Hall. Dicht, hell, relativ kurze "
    "Nachhallzeit, stark gerichtet (wenig diffus). Gut für Vocals, Snares.",
    "Room": "Natürlicher Raumklang. Ausgewogene frühe Reflexionen und "
    "Nachhall, mittlere Gerichtetheit. Universell einsetzbar für Realismus.",
    "Cathedral": "Große Kathedrale. Sehr langer, diffuser Nachhall, späte "
    "Reflexionen dominant, geringe Gerichtetheit. Für Ambient, orchestrale Sounds.",
}

# --- 3D parameter adaptation clips (raytracer_studio.py:211-236) ---
SIZE_DUR_EXP = 0.33
SIZE_DUR_CLIP = (0.5, 2.5)
SIZE_DELAY_EXP = 0.25
SIZE_DELAY_CLIP = (0.7, 1.8)
SIZE_REF_DIVISOR = 500.0
SIZE_REF_CLIP = (0.8, 1.5)
DURATION_CLIP = (0.1, 10.0)  # max internal IR length: 10 s (raytracer_studio.py:223)
REF_COUNT_CLIP = (5, 80)
Z_DELAY_SCALE = 0.1  # +/- 5% (raytracer_studio.py:227)
MAX_DELAY_CLIP = (0.01, 0.3)
SPLIT_TIME_CLIP = (0.02, 0.2)

# --- IR synthesis constants (raytracer_studio.py:238-308) ---
EARLY_STRENGTH_RANGE = (0.3, 0.8)  # uniform base strength per reflection (:264)
EARLY_DELAY_DECAY_EXP = 0.7  # strength *= 1 - (d/dmax)**0.7 (:267)
LATE_TAIL_TARGET_DB = -50.0  # tail targets -50 dB at the end (:274)
DECAY_ABSORPTION_SCALE = 0.1  # decay *= 1 - absorption*0.1 (:277)
DECAY_FACTOR_CLIP = (0.8, 0.99999)
LATE_INITIAL_AMP = 0.6  # :279
LATE_DIR_CLIP = (0.0, 0.9)
LATE_DURATION_AMP_CLIP = (0.3, 1.0)  # 1/(1+dur*0.5) clipped (:280)
NOISE_SMOOTH_MS_BASE = 0.001  # rate * 0.001 * (1 + 2*diffusion) (:284)
NOISE_SMOOTH_CLIP = (1, 10)
LATE_DIFFUSION_AMP_BOOST = 0.2  # amp *= 1 + diffusion*0.2 (:294)
EARLY_NORM_PEAK = 0.9  # early normalized to 0.9 excluding sample 0 (:301)
LATE_NORM_PEAK = 0.7  # late normalized to 0.7 (:303)

# --- Early/late level adaptation (raytracer_studio.py:168-182) ---
EARLY_LEVEL_DW_EXP = 1.5
EARLY_LEVEL_DW_SCALE = 0.7
LATE_LEVEL_DW_SCALE = 0.6
LEVEL_CLIP = (0.0, 2.0)

# --- Directionality model (raytracer_studio.py:184-209) ---
DIR_POSITION_CLIP = (0.5, 1.0)
DIR_DIFFUSION_SCALE = 0.8
DIR_DW_BOOST_START = 0.6
DIR_DW_BOOST_SCALE = 0.4
DIR_FINAL_CLIP = (0.05, 0.95)

# --- Air absorption low-pass (raytracer_studio.py:310-336) ---
AIR_ABSORPTION_START_HZ = 2000.0
AIR_ABSORPTION_MAX_DAMPING = 0.8
AIR_ABSORPTION_MIN_FACTOR = 0.01  # below this the filter is skipped (:312)

# --- Shelf EQ (raytracer_studio.py:393-396) ---
EQ_BASS_CUTOFF_HZ = 250.0
EQ_TREBLE_CUTOFF_HZ = 4000.0
EQ_GAIN_CLIP = (0.1, 5.0)

# --- Surround panning (raytracer_studio.py:464-505) ---
PAN_Z_EFFECT_SCALE = 0.3
PAN_MONO_MIX_GAIN = 0.707
PAN_LFE_GAIN = 0.15

# --- Layout mapping (raytracer_studio.py:517-571) ---
DOWNMIX_CENTER_GAIN = 0.707
DOWNMIX_REAR_GAIN = 0.5
SIDE_DELAY_MS = 12.0  # 7.1 SL/SR delay (:542)
SIDE_GAIN = 0.7
HEIGHT_DELAY_MS = 18.0  # 5.1.2 TFL/TFR delay (:549)
HEIGHT_Z_GAIN = 0.6

# --- Output contract (raytracer_studio.py:1082-1084) ---
OUTPUT_CLIP = 0.9999
OUTPUT_SUBTYPE = "PCM_16"

# --- Preset schema: the 16 ordered keys (raytracer_studio.py:883-887) ---
PRESET_KEYS: List[str] = [
    "use_external_ir",
    "hall_type",
    "material",
    "room_size",
    "diffusion",
    "air_absorption",
    "early_level",
    "late_level",
    "dry_wet",
    "dry_wet_kill_start",
    "bass_gain",
    "treble_gain",
    "x_pos",
    "y_pos",
    "z_pos",
    "target_layout",
]

PRESET_DEFAULTS: Dict[str, object] = {
    "use_external_ir": False,
    "hall_type": DEFAULT_HALL_TYPE,
    "material": DEFAULT_MATERIAL,
    "room_size": 100.0,
    "diffusion": 0.5,
    "air_absorption": 0.1,
    "early_level": 0.8,
    "late_level": 0.6,
    "dry_wet": 0.5,
    "dry_wet_kill_start": 0.5,
    "bass_gain": 1.0,
    "treble_gain": 1.0,
    "x_pos": 0.5,
    "y_pos": 0.5,
    "z_pos": 0.5,
    "target_layout": DEFAULT_CHANNEL_LAYOUT,
}

PRESET_FLOAT_KEYS: Tuple[str, ...] = (
    "room_size",
    "diffusion",
    "air_absorption",
    "early_level",
    "late_level",
    "dry_wet",
    "dry_wet_kill_start",
    "bass_gain",
    "treble_gain",
    "x_pos",
    "y_pos",
    "z_pos",
)
