"""Spatialization — port of ``audio_raytracing_studio_tpu/ops/spatial.py``.

3D pan (2→6) and layout mapping (6→{2,6,8}) as elementwise channel mixes
over (B, C, n) tensors (raytracer_studio.py:464-505, :517-571).  No matmul
runs here, so no TF32 setting can touch these sums.
"""

from __future__ import annotations

import math
from typing import List

import torch

from .. import config


def pan_matrix(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, 2, 6) stereo→5.1 mixing matrices from per-clip (B,) positions.

    Row = input channel (L, R); column = [FL, FR, C, LFE, RL, RR].  The C
    and LFE columns fold in the reference's mono mixdown (L+R)·0.707
    (raytracer_studio.py:483-485).
    """
    x = x.clamp(0.0, 1.0)
    y = y.clamp(0.0, 1.0)
    z = z.clamp(0.0, 1.0)

    gain_l = torch.sqrt(1.0 - x)
    gain_r = torch.sqrt(x)
    gain_f_base = torch.sqrt(1.0 - y)
    gain_re_base = torch.sqrt(y)
    z_pull = (0.5 - z) * ((y - 0.5).abs() * config.PAN_Z_EFFECT_SCALE)
    gain_f = (gain_f_base + z_pull).clamp(min=0.0)
    gain_re = (gain_re_base - z_pull).clamp(min=0.0)

    fl = gain_l * gain_f
    fr = gain_r * gain_f
    rl = gain_l * gain_re
    rr = gain_r * gain_re
    center = torch.cos((x - 0.5) * math.pi) * gain_f
    c_coef = config.PAN_MONO_MIX_GAIN * center
    lfe_coef = torch.full_like(fl, config.PAN_MONO_MIX_GAIN * config.PAN_LFE_GAIN)

    zero = torch.zeros_like(fl)
    row_l = torch.stack([fl, zero, c_coef, lfe_coef, rl, zero], dim=-1)
    row_r = torch.stack([zero, fr, c_coef, lfe_coef, zero, rr], dim=-1)
    return torch.stack([row_l, row_r], dim=-2).to(torch.float32)


def apply_pan(audio: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """audio (B, 2, n) through pan matrices (B, 2, 6) → (B, 6, n), as six
    elementwise mixes."""
    left = audio[:, 0, :]
    right = audio[:, 1, :]
    out = [left * matrix[:, 0, c, None] + right * matrix[:, 1, c, None] for c in range(6)]
    return torch.stack(out, dim=-2)


def _delay_last_axis(x: torch.Tensor, delay: int) -> torch.Tensor:
    """Zero-pad front, trim tail — apply_delay (raytracer_studio.py:507-515)."""
    if delay <= 0:
        return x
    n = x.shape[-1]
    return torch.nn.functional.pad(x, (delay, 0))[..., :n]


def map_layout(
    data_6ch: torch.Tensor,
    target_layout_name: str,
    rate: int,
    z_pos: torch.Tensor,
) -> torch.Tensor:
    """Map (B, 6, n) onto the target layout (static branch by layout name).

    Mirrors map_channels (raytracer_studio.py:517-571) minus the trailing
    conditional normalization (the pipeline applies that separately).
    z_pos is (B,).
    """
    if target_layout_name not in config.CHANNEL_LAYOUTS:
        target_layout_name = config.DEFAULT_CHANNEL_LAYOUT

    if target_layout_name == "Stereo":
        c = config.DOWNMIX_CENTER_GAIN
        r = config.DOWNMIX_REAR_GAIN
        left = data_6ch[:, 0, :] + data_6ch[:, 2, :] * c + data_6ch[:, 4, :] * r
        right = data_6ch[:, 1, :] + data_6ch[:, 2, :] * c + data_6ch[:, 5, :] * r
        return torch.stack([left, right], dim=-2)

    if target_layout_name == "5.1 (Standard)":
        return data_6ch

    if target_layout_name == "7.1 (Surround)":
        delay = int(rate * config.SIDE_DELAY_MS / 1000)
        sides = _delay_last_axis(data_6ch[:, 4:6, :], delay) * config.SIDE_GAIN
        return torch.cat([data_6ch, sides], dim=-2)

    # 5.1.2 (Atmos Light)
    delay = int(rate * config.HEIGHT_DELAY_MS / 1000)
    height_gain = z_pos.clamp(0.0, 1.0) * config.HEIGHT_Z_GAIN
    heights = _delay_last_axis(data_6ch[:, 4:6, :], delay) * height_gain[:, None, None]
    return torch.cat([data_6ch, heights], dim=-2)


def layout_channel_names(target_layout_name: str) -> List[str]:
    layout = config.CHANNEL_LAYOUTS.get(
        target_layout_name, config.CHANNEL_LAYOUTS[config.DEFAULT_CHANNEL_LAYOUT]
    )
    return list(layout["names"])
