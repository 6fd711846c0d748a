"""The least bytes a kernel's contract moves, and its share of the card's
bandwidth roofline.  Counts each input byte read once and each output byte
written once, from the shapes, whatever implements the function."""

from __future__ import annotations

from typing import Optional

import torch

from .harness import ROOT, load_json


def hbm_bytes_per_s(device) -> Optional[float]:
    """The card's published memory bandwidth, or None for a card the table
    does not list (then no roofline share is reported)."""
    if torch.device(device).type != "cuda":
        return None
    entry = load_json(ROOT / "peaks.json").get(torch.cuda.get_device_name(device))
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def share_pct(nbytes: float, seconds: float, device) -> Optional[float]:
    """100 × (bytes / peak bandwidth) / measured seconds."""
    peak = hbm_bytes_per_s(device)
    if peak is None or not seconds > 0:
        return None
    return 100.0 * nbytes / peak / seconds
