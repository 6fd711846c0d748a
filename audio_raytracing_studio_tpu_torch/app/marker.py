"""Interactive 3D-position map utilities (PIL) — marker drawing + placeholder.

The map helpers of raytracer_studio.py:817-862 and the placeholder generation
at :1337-1342; the port's own copy of
``audio_raytracing_studio_tpu/app/marker.py``.  PIL is imported inside the
functions that draw, so the module (and the studio, and ``compat``) imports
on a machine without it.
"""

from __future__ import annotations

import importlib.util
import os
import tempfile
from typing import Optional

import numpy as np

from .. import config


#: map canvas (w, h) — 3:2 like the reference's surround_layout_3d.png
MAP_SIZE = (600, 400)


def _draw_speaker(draw, x: int, y: int, name: str,
                  color=(36, 64, 120), height: bool = False) -> None:
    """A speaker glyph: filled box (dashed ring when height channel) + label."""
    r = 13
    if height:
        draw.ellipse((x - r - 5, y - r - 5, x + r + 5, y + r + 5),
                     outline=(130, 150, 200), width=2)
    draw.rounded_rectangle((x - r, y - r, x + r, y + r), radius=4,
                           fill=color, outline=(15, 25, 50), width=2)
    draw.ellipse((x - 5, y - 5, x + 5, y + 5), fill=(225, 235, 255))
    tw = draw.textlength(name)
    draw.text((x - tw / 2, y + r + 4), name, fill=(25, 35, 70))


def render_map_asset(path: str) -> str:
    """Render the top-down speaker-layout map (replaces the reference's
    shipped surround_layout_3d.png, raytracer_studio.py:26): room outline,
    listener, the union of speaker positions across the supported layouts
    (config.CHANNEL_LAYOUTS), height channels ringed.  Click semantics are
    unchanged — x→L/R, y→front/back, normalized over the full image."""
    from PIL import Image, ImageDraw

    w, h = MAP_SIZE
    img = Image.new("RGB", (w, h), color=(237, 240, 247))
    draw = ImageDraw.Draw(img)

    # room: soft floor gradient + walls
    m = 28
    for i in range(h - 2 * m):
        t = i / max(1, h - 2 * m - 1)
        c = (int(218 - 16 * t), int(224 - 12 * t), int(238 - 8 * t))
        draw.line((m, m + i, w - m, m + i), fill=c)
    draw.rectangle((m, m, w - m, h - m), outline=(90, 100, 130), width=3)
    for frac in (0.25, 0.5, 0.75):  # light grid
        gx = m + frac * (w - 2 * m)
        gy = m + frac * (h - 2 * m)
        draw.line((gx, m, gx, h - m), fill=(205, 210, 226))
        draw.line((m, gy, w - m, gy), fill=(205, 210, 226))

    def pos(nx: float, ny: float) -> tuple[int, int]:
        return (int(m + nx * (w - 2 * m)), int(m + ny * (h - 2 * m)))

    # listener (center, facing front/top)
    cx, cy = pos(0.5, 0.5)
    draw.ellipse((cx - 16, cy - 16, cx + 16, cy + 16),
                 fill=(250, 250, 252), outline=(60, 70, 100), width=3)
    draw.polygon([(cx, cy - 26), (cx - 8, cy - 13), (cx + 8, cy - 13)],
                 fill=(60, 70, 100))
    draw.text((cx - draw.textlength("Hörer") / 2, cy + 20), "Hörer",
              fill=(60, 70, 100))

    # union of speakers across layouts (normalized room coordinates)
    speakers = {
        "FL": (0.18, 0.10), "FR": (0.82, 0.10), "C": (0.50, 0.06),
        "LFE": (0.34, 0.06), "RL": (0.18, 0.90), "RR": (0.82, 0.90),
        "SL": (0.05, 0.50), "SR": (0.95, 0.50),
        "TFL": (0.32, 0.26), "TFR": (0.68, 0.26),
    }
    for name, (nx, ny) in speakers.items():
        x, y = pos(nx, ny)
        height_ch = name.startswith("T")
        color = (120, 90, 40) if name == "LFE" else (36, 64, 120)
        _draw_speaker(draw, x, y, name, color=color, height=height_ch)

    # axes / usage hints
    draw.text((w / 2 - draw.textlength("VORNE") / 2, 6), "VORNE", fill=(70, 80, 110))
    draw.text((w / 2 - draw.textlength("HINTEN") / 2, h - 20), "HINTEN", fill=(70, 80, 110))
    draw.text((6, h / 2 - 6), "L", fill=(70, 80, 110))
    draw.text((w - 14, h / 2 - 6), "R", fill=(70, 80, 110))
    draw.text((m + 4, m + 4), "Klicken setzt X/Y", fill=(110, 120, 150))
    img.save(path, "PNG")
    return path


def pil_available() -> bool:
    """Whether PIL can be imported (it is optional beside the card)."""
    return importlib.util.find_spec("PIL") is not None


def ensure_map_asset(base_path: Optional[str] = None) -> str:
    """Render the surround map PNG if the asset is missing.  Without PIL the
    map stays missing, and the handlers treat it like any missing base image
    (``update_marker_image`` → None): the studio still starts and renders."""
    path = base_path or config.BASE_SURROUND_MAP_PATH
    if not os.path.exists(path) and pil_available():
        render_map_asset(path)
    return path


def update_marker_image(
    x_pos: float, y_pos: float, base_image_path: Optional[str] = None
) -> Optional[str]:
    """Draw the red position marker onto the map → temp PNG path (ref :817-839)."""
    base_path = base_image_path
    if not base_path or not isinstance(base_path, str) or not os.path.exists(base_path):
        if os.path.exists(config.BASE_SURROUND_MAP_PATH):
            base_path = config.BASE_SURROUND_MAP_PATH
        else:
            return None
    try:
        from PIL import Image, ImageDraw

        x = float(x_pos)
        y = float(y_pos)
        with Image.open(base_path).convert("RGBA") as bg:
            width, height = bg.size
            if width <= 0 or height <= 0:
                return None
            x_pixel = int(np.clip(x, 0.0, 1.0) * (width - 1))
            y_pixel = int(np.clip(y, 0.0, 1.0) * (height - 1))
            out = bg.copy()
            draw = ImageDraw.Draw(out)
            radius = max(5, min(width, height) // 60)
            outline_width = max(1, radius // 4)
            bbox = (x_pixel - radius, y_pixel - radius, x_pixel + radius, y_pixel + radius)
            draw.ellipse(
                bbox,
                fill=(255, 0, 0, 200),
                outline=(255, 255, 255, 220),
                width=outline_width,
            )
        with tempfile.NamedTemporaryFile(delete=False, suffix=".png", prefix="marker_") as tmp:
            out.save(tmp.name, "PNG")
            return tmp.name
    except Exception:  # noqa: BLE001 — marker failure must not break the UI
        return None


def click_to_normalized(
    x_click: float, y_click: float, base_image_path: Optional[str] = None
) -> Optional[tuple[float, float]]:
    """Pixel click coordinates → normalized (x, y) (ref :841-854)."""
    base_path = base_image_path or config.BASE_SURROUND_MAP_PATH
    if not os.path.exists(base_path):
        return None
    from PIL import Image

    with Image.open(base_path) as img:
        width, height = img.size
    if width <= 0 or height <= 0:
        return None
    return (
        float(np.clip(x_click / width, 0.0, 1.0)),
        float(np.clip(y_click / height, 0.0, 1.0)),
    )
