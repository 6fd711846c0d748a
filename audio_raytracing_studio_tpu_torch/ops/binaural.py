"""Binaural (headphone) downmix of surround renders — port of
``audio_raytracing_studio_tpu/ops/binaural.py``.

A parametric spherical-head model (no external HRTF data) applied in the
frequency domain, one pass:

  Ear(f) = Σ_ch X_ch(f) · G_ild(ch, ear, f) · e^{−i 2π f τ_itd(ch, ear)}

- ITD: Woodworth spherical-head delay τ(θ) = (a/c)·(θ + sin θ) toward the
  contralateral ear (a = 8.75 cm head radius);
- ILD: a first-order high-frequency rolloff on the far ear that deepens with
  source azimuth, a mild brightening of the near ear;
- elevation (5.1.2 height channels): a presence-band (~7 kHz) tilt.

Channel azimuths follow ITU-R BS.775.  The ear-filter table is built on the
device in float64 and cast to complex64; the mix is one ``torch.fft`` rfft of
the channels, a multiply by the table, an elementwise sum over channels and
one irfft per ear.

The transform size is the JAX package's, on purpose: the clip length rounded
up to the half-second grid (``parallel.sharding.bucket_length``), plus the
largest ITD and 256 samples of headroom, rounded up to a power of two.  The
ear filters are sampled on that ``rfftfreq(nfft)`` grid, so another size
would give another output, not only another speed.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import config
from ..utils.runtime import ensure_device

HEAD_RADIUS_M = 0.0875
SPEED_OF_SOUND = 343.0

# (azimuth degrees, elevation degrees) per channel name; azimuth >0 = right.
CHANNEL_ANGLES = {
    "FL": (-30.0, 0.0),
    "FR": (30.0, 0.0),
    "C": (0.0, 0.0),
    "LFE": (0.0, 0.0),
    "RL": (-110.0, 0.0),
    "RR": (110.0, 0.0),
    "SL": (-90.0, 0.0),
    "SR": (90.0, 0.0),
    "TFL": (-45.0, 45.0),
    "TFR": (45.0, 45.0),
}


def _itd_seconds(azimuth_rad: float) -> float:
    """Woodworth ITD toward the far ear for a source at ``azimuth``."""
    a = abs(azimuth_rad)
    return HEAD_RADIUS_M / SPEED_OF_SOUND * (a + math.sin(a))


def _ear_filters(azimuth_deg: float, elevation_deg: float, freqs: torch.Tensor):
    """(left, right) ear responses for one source direction, each as a
    (gain, phase angle) pair of float64 tensors over ``freqs``."""
    az = math.radians(azimuth_deg)
    out = []
    for ear_sign in (-1.0, 1.0):  # -1 = left ear, +1 = right ear
        same_side = az * ear_sign >= 0
        # ITD: far ear delayed; near ear reference
        tau = 0.0 if same_side else _itd_seconds(az)
        angle = freqs * (-2.0 * math.pi) * tau

        # ILD head shadow: first-order rolloff on the far ear whose corner
        # drops with azimuth (fully lateral source → ~1.2 kHz corner, ~9 dB
        # deep at 8 kHz); near ear gets a mild bright boost.
        lateral = abs(math.sin(az))
        if same_side:
            gain = 1.0 + 0.15 * lateral * (freqs / 4000.0).clamp(0.0, 1.5)
        else:
            fc = 12000.0 - 10800.0 * lateral  # 12 kHz (front) → 1.2 kHz (side)
            gain = 1.0 / torch.sqrt(1.0 + (freqs / max(fc, 200.0)) ** 2)
            gain = gain * (1.0 - 0.25 * lateral)

        # Elevation: presence-band (~7 kHz) tilt upward for height channels.
        if elevation_deg > 0:
            bump = 0.2 * (elevation_deg / 45.0)
            gain = gain * (1.0 + bump * torch.exp(-(((freqs - 7000.0) / 2500.0) ** 2)))
        out.append((gain, angle))
    return out[0], out[1]


@functools.lru_cache(maxsize=4)
def _binaural_table(layout_key: tuple, rate: int, nfft: int, device: str) -> torch.Tensor:
    """(num_channels, 2, nfft//2+1) complex64 ear-filter table on ``device``.

    maxsize stays small: one entry is C·nfft·8 bytes (~200 MB for 60 s of
    5.1 at 48 kHz), and the directory renderer meets a new transform size
    for every length bucket."""
    # np.fft.rfftfreq(nfft, 1 / rate), computed the same way
    freqs = torch.arange(nfft // 2 + 1, dtype=torch.float64, device=device)
    freqs = freqs * (1.0 / (nfft * (1.0 / rate)))
    inv_sqrt2 = 1.0 / math.sqrt(2.0)  # constant-power normalization over ears
    rows = []
    for name in layout_key:
        az, el = CHANNEL_ANGLES.get(name, (0.0, 0.0))
        for gain, angle in _ear_filters(az, el, freqs):
            rows.append(torch.complex(
                (gain * torch.cos(angle) * inv_sqrt2).to(torch.float32),
                (gain * torch.sin(angle) * inv_sqrt2).to(torch.float32),
            ))
    return torch.stack(rows).reshape(len(layout_key), 2, -1)


def _binaural_mix(x_cn: torch.Tensor, table: torch.Tensor, nfft: int, n: int) -> torch.Tensor:
    """(C, n) float32 → (2, n) float32 ears on the tensors' device."""
    spec = torch.fft.rfft(x_cn, n=nfft)
    # an elementwise sum over the small channel axis, as the JAX package
    # does; no contraction, so no matmul precision setting is involved
    ears = (spec[:, None, :] * table).sum(dim=0)
    return torch.fft.irfft(ears, n=nfft)[:, :n]


def transform_size(names, n: int, rate: int) -> int:
    """The power-of-two transform size of ``binauralize`` for ``n`` samples."""
    from ..parallel.sharding import bucket_length

    # FFT headroom: the ITD delay in SAMPLES scales with the rate (~0.00073 s
    # for a fully lateral source — 35 samples at 48 kHz but ~280 at 384 kHz),
    # so a fixed pad would wrap the delayed contralateral tail into the clip
    # start at high rates; +256 covers the zero-phase shadow-filter smear.
    max_itd = max(
        _itd_seconds(math.radians(CHANNEL_ANGLES.get(nm, (0.0, 0.0))[0])) for nm in names
    )
    need = bucket_length(n, rate) + int(math.ceil(max_itd * rate)) + 256
    return 1 << (need - 1).bit_length()


def binauralize(data_nc: np.ndarray, rate: int, layout_name: str, device="cuda") -> np.ndarray:
    """Surround (n, C) → binaural stereo (n, 2) float32 on the host, computed
    on ``device``."""
    dev = ensure_device(device)
    layout = config.CHANNEL_LAYOUTS.get(layout_name)
    if layout is None or layout["channels"] != data_nc.shape[1]:
        raise ValueError(
            f"layout {layout_name!r} does not match {data_nc.shape[1]} channels"
        )
    names = tuple(layout["names"])
    n = data_nc.shape[0]
    nfft = transform_size(names, n, int(rate))
    table = _binaural_table(names, int(rate), nfft, str(dev))
    x_cn = torch.from_numpy(np.ascontiguousarray(np.asarray(data_nc, np.float32).T)).to(dev)
    return _binaural_mix(x_cn, table, nfft, n).cpu().numpy().T
