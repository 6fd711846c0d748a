"""Plain reference of the internal-hall render the benchmark drives.

A second implementation of the same semantics as the program's batched
render, written from the reference app's definitions (the float64 host
parameter math, the counter-based seed stream, IR synthesis, linear FFT
convolution, the exact-length circular air and shelf filters, dry/wet mix,
conditional normalizations, 3D pan, layout map, the BS.1770 meter and the
16-bit output contract).  It imports nothing of the program: the constants
and the host parameter math below are frozen copies, and every row is
rendered on its own, in float64, with no kernel, bank, bucket or batching.

``Precision`` picks the arithmetic: ``FLOAT64`` is the reference;
``BF16`` is the lower-precision control (float32 arithmetic with every
stage's result stored in bfloat16), which the comparison must reject.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# --- constants of the reference app (frozen copy) ---------------------------
HALLS = {  # ir_duration_s, reflection_count, max_early_delay_s, early_late_split_s
    "Plate": (0.8, 25, 0.025, 0.03),
    "Room": (1.5, 35, 0.06, 0.08),
    "Cathedral": (4.0, 20, 0.10, 0.12),
}
HALL_DIRECTIONALITY = {"Plate": 0.95, "Room": 0.65, "Cathedral": 0.25}
MATERIAL_ABSORPTION = {
    "Stein": 0.15, "Holz": 0.35, "Teppich": 0.7, "Glas": 0.2, "Beton": 0.1,
    "Vorhang (schwer)": 0.8,
}
LAYOUT_CHANNELS = {"Stereo": 2, "5.1 (Standard)": 6, "7.1 (Surround)": 8,
                   "5.1.2 (Atmos Light)": 8}
MAX_REFLECTIONS = 80
OUTPUT_CLIP = 0.9999

DEFAULTS = dict(
    hall_type="Room", material="Holz", room_size=100.0, diffusion=0.5,
    air_absorption=0.1, early_level=0.8, late_level=0.6, dry_wet=0.5,
    dry_wet_kill_start=0.5, bass_gain=1.0, treble_gain=1.0, x_pos=0.5,
    y_pos=0.5, z_pos=0.5, target_layout="5.1 (Standard)",
)

# --- seed stream: bits(i) = lowbias32(lowbias32(seed ^ salt) + i * PHI) -----
MASK32 = 0xFFFFFFFF
PHI = 0x9E3779B9
DELAY_SALT, STRENGTH_SALT, NOISE_SALT = 0xA511E9B3, 0x63D83595, 0xC2B2AE35


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    store: Optional[torch.dtype]  # every stage's result is rounded to this

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.store is None:
            return x
        return x.to(self.store).to(self.dtype)


FLOAT64 = Precision("float64", torch.float64, None)
BF16 = Precision("bf16", torch.float32, torch.bfloat16)


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def _stream(seed: int, salt: int, count: int, device) -> torch.Tensor:
    mix = _lowbias32(torch.tensor((int(seed) & MASK32) ^ salt, dtype=torch.int64))
    i = torch.arange(count, dtype=torch.int64, device=device)
    return _lowbias32((mix.to(device) + i * PHI) & MASK32)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → [0, 1) from the top 23 bits (exact in float64)."""
    return (bits >> 9).to(torch.float64) * 2.0 ** -23


# --- host parameter math (float64, the reference app's formulas) ------------
def _clip(x, lo, hi):
    return float(min(max(x, lo), hi))


def derive(p: dict, rate: int) -> dict:
    """Every scalar and shape of one render from its preset values."""
    p = {**DEFAULTS, **p}
    dur, count, max_delay, split = HALLS.get(p["hall_type"], HALLS["Room"])
    size = float(p["room_size"])
    z = float(p["z_pos"])
    if size <= 0:
        f_dur, f_delay = 0.5, 0.7
    else:
        f_dur = _clip((size / 100.0) ** 0.33, 0.5, 2.5)
        f_delay = _clip((size / 100.0) ** 0.25, 0.7, 1.8)
    f_ref = _clip(1 + (size - 100) / 500.0, 0.8, 1.5)
    ir_duration = _clip(dur * f_dur, 0.1, 10.0)
    ref_count = int(_clip(int(count * f_ref), 5, 80))
    max_delay = _clip(max_delay * f_delay * (1.0 + (z - 0.5) * 0.1), 0.01, 0.3)
    split_time = _clip(split * f_delay, 0.02, 0.2)

    x, y = _clip(p["x_pos"], 0, 1), _clip(p["y_pos"], 0, 1)
    zc = _clip(z, 0, 1)
    diffusion = _clip(p["diffusion"], 0, 1)
    dw = _clip(p["dry_wet"], 0, 1)
    dist_xz = math.sqrt(((x - 0.5) * 2) ** 2 + ((zc - 0.5) * 1.0) ** 2) / math.sqrt(1.25)
    position = _clip((1.0 - dist_xz * 0.3) * (1.0 - abs(y - 0.5) * 2 * 0.2), 0.5, 1.0)
    base = HALL_DIRECTIONALITY.get(p["hall_type"], 0.65)
    directionality = _clip(base * position * (1.0 - diffusion * 0.8)
                           + max(0.0, (dw - 0.6) * 0.4), 0.05, 0.95)

    length = max(1, int(ir_duration * rate))
    absorption = MATERIAL_ABSORPTION.get(p["material"], MATERIAL_ABSORPTION["Holz"])
    split_point = max(1, min(int(split_time * rate), length - 1))
    actual_max_early = min(max(2, int(max_delay * rate)), split_point)
    late_length = length - split_point
    decay = float(np.power(10 ** (-50.0 / 20.0), 1.0 / late_length)) if late_length > 1 else 0.1
    decay = _clip(decay * (1.0 - absorption * 0.1), 0.8, 0.99999)
    amp = 0.6 * (1.0 - _clip(directionality, 0.0, 0.9))
    amp *= _clip(1.0 / (1 + ir_duration * 0.5), 0.3, 1.0)
    amp *= 1.0 - absorption ** 0.5
    amp *= 1.0 + diffusion * 0.2
    smooth = int(_clip(rate * 0.001 * (1.0 + diffusion * 2.0), 1, 10))

    early_lvl = _clip(float(p["early_level"]) * (1.0 - dw ** 1.5 * 0.7), 0.0, 2.0)
    late_lvl = _clip(float(p["late_level"]) * (1.0 + dw ** 1.5 * 0.6), 0.0, 2.0)
    ks = _clip(p["dry_wet_kill_start"], 0, 1)
    dry_factor = 1.0
    if ks < 1.0 and dw >= ks:
        dry_factor = 0.0 if 1.0 - ks < 1e-6 else _clip(1.0 - (dw - ks) / (1.0 - ks), 0, 1)
    taps_active = ref_count > 0 and split_point > 1 and actual_max_early > 1
    air = float(p["air_absorption"])
    return dict(
        length=length, split_point=split_point, actual_max_early=actual_max_early,
        ref_count=ref_count, late_length=late_length, smooth=smooth,
        absorption=absorption, directionality=directionality, decay=decay, amp=amp,
        taps_active=taps_active, early_on=taps_active and early_lvl > 1e-6,
        late_on=late_length > 0 and late_lvl > 1e-6,
        early_lvl=early_lvl, late_lvl=late_lvl, dry_wet=dw, dry_factor=dry_factor,
        air=air if air > 0.01 else 0.0,
        eq_on=not (np.isclose(p["bass_gain"], 1.0) and np.isclose(p["treble_gain"], 1.0)),
        bass=_clip(p["bass_gain"], 0.1, 5.0), treble=_clip(p["treble_gain"], 0.1, 5.0),
        x=x, y=y, z=zc, layout=p["target_layout"] if p["target_layout"] in LAYOUT_CHANNELS
        else "5.1 (Standard)",
    )


def fast_fft_length(n: int) -> int:
    """Smallest 2^k or 3·2^k ≥ n: the convolution grid, on which the fast
    air gain is sampled."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    m = 1 << max(0, (n + 2) // 3 - 1).bit_length()
    return min(p, 3 * m)


# --- IR synthesis -------------------------------------------------------------
def impulse_responses(seed: int, g: dict, prec: Precision, device):
    """(early, late) of length g["length"] from the seed's stream."""
    dt = prec.dtype
    early = torch.zeros(g["length"], dtype=dt, device=device)
    late = torch.zeros(g["length"], dtype=dt, device=device)
    if g["taps_active"]:
        hi = max(2, g["actual_max_early"])
        delays = 1 + _stream(seed, DELAY_SALT, MAX_REFLECTIONS, device) % max(1, hi - 1)
        strengths = 0.3 + _unit(_stream(seed, STRENGTH_SALT, MAX_REFLECTIONS, device)) * 0.5
        k = torch.arange(MAX_REFLECTIONS, device=device)
        valid = (k < g["ref_count"]) & (delays > 0) & (delays < g["split_point"])
        falloff = 1.0 - (delays.to(torch.float64) / g["actual_max_early"]) ** 0.7
        amps = (strengths * (1.0 - g["absorption"])
                * _clip(g["directionality"], 0.1, 1.0) * falloff)
        amps = torch.where(valid, amps, 0.0).to(dt)
        early = early.index_add(0, torch.where(valid, delays, 0), amps)
    n_late = g["late_length"]
    if n_late > 0:
        noise = (-1.0 + _unit(_stream(seed, NOISE_SALT, n_late, device)) * 2.0).to(dt)
        w = g["smooth"]
        smoothed = noise
        if w > 1 and n_late >= w:
            lead = w // 2
            padded = torch.nn.functional.pad(noise, (lead, w - 1 - lead))
            avg = sum(padded[k:k + n_late] for k in range(w)) / w
            sd_raw = noise.std(correction=0)
            sd_avg = avg.std(correction=0)
            smoothed = avg / sd_avg * sd_raw if float(sd_avg) > 1e-6 else noise
        k = torch.arange(n_late, dtype=torch.float64, device=device)
        envelope = torch.exp(k * math.log(g["decay"])).to(dt)
        late[g["split_point"]:] = smoothed * g["amp"] * envelope
    if g["length"] > 1:
        peak = float(early[1:].abs().max())
        if peak > 1e-6:
            early = early * (0.9 / peak)
    peak = float(late.abs().max())
    if peak > 1e-6:
        late = late * (0.7 / peak)
    return prec.q(early), prec.q(late)


# --- filters ------------------------------------------------------------------
def _freqs(n: int, rate: int, device) -> torch.Tensor:
    """np.fft.rfftfreq(n, 1/rate) in float64."""
    return torch.arange(n // 2 + 1, dtype=torch.float64, device=device) * (1.0 / (n * (1.0 / rate)))


def air_gain(n: int, rate: int, factor: float, device) -> torch.Tensor:
    """1 below 2 kHz, falling linearly to 1 − 0.8·factor at Nyquist."""
    f = _freqs(n, rate, device)
    top = (n // 2) * (1.0 / (n * (1.0 / rate)))
    if top <= 2000.0:
        ramp = torch.zeros_like(f)
    else:
        ramp = torch.where(f >= 2000.0, ((f - 2000.0) / (top - 2000.0)).clamp(0, 1), 0.0)
    return 1.0 - ramp * (_clip(factor, 0, 1) * 0.8)


def shelf_gain(n: int, rate: int, bass: float, treble: float, device) -> torch.Tensor:
    """bass on (0, 250] Hz, treble on [4 kHz, Nyquist], 1 elsewhere."""
    f = _freqs(n, rate, device)
    g = torch.where((f > 1e-6) & (f <= 250.0), bass, 1.0)
    return torch.where(f >= 4000.0, treble, g)


def circular(x: torch.Tensor, gain: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Circular filter of each row of x (C, n) at its exact length n."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, n=n) * gain.to(x.dtype)
    return prec.q(torch.fft.irfft(spec, n=n))


def normalize(x: torch.Tensor) -> torch.Tensor:
    peak = float(x.abs().max())
    if peak < 1e-9:
        return torch.zeros_like(x)
    return x / peak if peak > 1.0 else x


def pan(x: torch.Tensor, g: dict) -> torch.Tensor:
    """(2, n) → (6, n): FL FR C LFE RL RR."""
    xp, yp, zp = g["x"], g["y"], g["z"]
    z_pull = (0.5 - zp) * (abs(yp - 0.5) * 0.3)
    front = max(math.sqrt(1.0 - yp) + z_pull, 0.0)
    rear = max(math.sqrt(yp) - z_pull, 0.0)
    left, right = math.sqrt(1.0 - xp), math.sqrt(xp)
    centre = 0.707 * math.cos((xp - 0.5) * math.pi) * front
    lfe = 0.707 * 0.15
    l_in, r_in = x[0], x[1]
    return torch.stack([
        l_in * (left * front), r_in * (right * front), (l_in + r_in) * centre,
        (l_in + r_in) * lfe, l_in * (left * rear), r_in * (right * rear),
    ])


def _delayed(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (d, 0))[..., :x.shape[-1]] if d > 0 else x


def layout(six: torch.Tensor, g: dict, rate: int) -> torch.Tensor:
    name = g["layout"]
    if name == "Stereo":
        return torch.stack([six[0] + six[2] * 0.707 + six[4] * 0.5,
                            six[1] + six[2] * 0.707 + six[5] * 0.5])
    if name == "5.1 (Standard)":
        return six
    if name == "7.1 (Surround)":
        return torch.cat([six, _delayed(six[4:6], int(rate * 12.0 / 1000)) * 0.7])
    return torch.cat([six, _delayed(six[4:6], int(rate * 18.0 / 1000)) * (g["z"] * 0.6)])


# --- one row ------------------------------------------------------------------
def render_row(clip: np.ndarray, rate: int, params: dict, seed: int,
               clip_length: Optional[int] = None, fast: bool = False,
               padded_eq: bool = False, prec: Precision = FLOAT64, device="cpu"):
    """One clip (n,) or (n, C) → (channels, len_out) output and its valid
    (true) output length.

    ``clip_length``: the clip's true length inside a zero-padded buffer.
    ``padded_eq``: the batch carried a padded clip with EQ on, so every row
    is filtered at its true length and is zero past it (else the EQ, where
    on, runs at the buffer length)."""
    g = derive(params, rate)
    a = torch.as_tensor(np.asarray(clip, np.float32)).to(device=device, dtype=prec.dtype)
    a = a[:, None] if a.dim() == 1 else a
    a = prec.q((a.expand(-1, 2) if a.shape[1] == 1 else a[:, :2]).T.contiguous())  # (2, n)
    n = a.shape[-1]
    ir_len = g["length"]
    len_out = n + ir_len - 1
    valid = len_out if clip_length is None else min(int(clip_length), n) + ir_len - 1
    early, late = impulse_responses(seed, g, prec, device)
    e_w = g["early_lvl"] if g["early_on"] else 0.0
    l_w = g["late_lvl"] if g["late_on"] else 0.0
    nfft = fast_fft_length(n + ir_len - 1)
    spec = torch.fft.rfft(a, n=nfft)
    if fast or g["air"] == 0.0:
        kern = e_w * torch.fft.rfft(early, n=nfft) + l_w * (
            torch.fft.rfft(late, n=nfft)
            * air_gain(nfft, rate, g["air"], device).to(prec.dtype))
        wet = prec.q(torch.fft.irfft(spec * kern, n=nfft)[:, :len_out])
    else:
        e_wet = prec.q(torch.fft.irfft(spec * torch.fft.rfft(early, n=nfft), n=nfft)[:, :len_out])
        l_wet = prec.q(torch.fft.irfft(spec * torch.fft.rfft(late, n=nfft), n=nfft)[:, :len_out])
        l_wet = circular(l_wet, air_gain(len_out, rate, g["air"], device), prec)
        wet = prec.q(e_w * e_wet + l_w * l_wet)
    dry = torch.nn.functional.pad(a, (0, len_out - n))
    mixed = prec.q(g["dry_factor"] * (1.0 - g["dry_wet"]) * dry + g["dry_wet"] * wet)
    if padded_eq:
        n0 = valid
        out = torch.zeros_like(mixed)
        gain = shelf_gain(n0, rate, g["bass"], g["treble"], device)
        out[:, :n0] = circular(mixed[:, :n0], gain, prec)
        mixed = out
    elif g["eq_on"]:
        mixed = circular(mixed, shelf_gain(len_out, rate, g["bass"], g["treble"], device), prec)
    mixed = prec.q(normalize(mixed))
    six = prec.q(normalize(prec.q(pan(mixed, g))))
    out = prec.q(normalize(prec.q(layout(six, g, rate))))
    return out, valid


# --- the meter ----------------------------------------------------------------
def _k_weighting(rate: float):
    """BS.1770-4 prefilter biquads (De Man's parameterisation), float64."""
    k = math.tan(math.pi * 1681.974450955533 / rate)
    vh = 10.0 ** (3.999843853973347 / 20.0)
    vb = vh ** 0.4996667741545416
    q = 0.7071752369554196
    d = 1.0 + k / q + k * k
    shelf = (np.array([(vh + vb * k / q + k * k) / d, 2.0 * (k * k - vh) / d,
                       (vh - vb * k / q + k * k) / d]),
             np.array([1.0, 2.0 * (k * k - 1.0) / d, (1.0 - k / q + k * k) / d]))
    k = math.tan(math.pi * 38.13547087602444 / rate)
    q = 0.5003270373238773
    d = 1.0 + k / q + k * k
    high = (np.array([1.0, -2.0, 1.0]),
            np.array([1.0, 2.0 * (k * k - 1.0) / d, (1.0 - k / q + k * k) / d]))
    return [shelf, high]


def _db(x: float) -> float:
    return 20.0 * math.log10(x) if x > 1e-15 else -math.inf


def meter(out: torch.Tensor, valid: int, rate: int, prec: Precision = FLOAT64) -> dict:
    """LUFS (gated, of the mean of the first two channels), sample peak and
    RMS in dBFS of ``out[:, :valid]`` (the RMS over the whole buffer's
    energy, which is zero past ``valid``)."""
    from scipy.signal import lfilter

    x = out.to(torch.float64).cpu().numpy()
    mono = x[0, :valid] if x.shape[0] == 1 else x[:2, :valid].mean(axis=0)
    weighted = mono
    for b, a in _k_weighting(rate):
        weighted = lfilter(b, a, weighted)
    if prec.store is not None:
        weighted = prec.q(torch.from_numpy(weighted)).numpy().astype(np.float64)
    t = valid / rate
    blocks = 0 if t < 0.4 else int(round((t - 0.4) / (0.4 * 0.25))) + 1
    lufs = -math.inf
    if blocks > 0 and float(np.abs(mono).max()) >= 1e-6:
        j = np.arange(blocks)
        lo = (0.4 * (j * 0.25) * rate).astype(np.int64)
        hi = np.minimum((0.4 * (j * 0.25 + 1) * rate).astype(np.int64), valid)
        prefix = np.concatenate([[0.0], np.cumsum(weighted * weighted)])
        z = (prefix[hi] - prefix[lo]) / (0.4 * rate)
        loud = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))
        gate = loud >= -70.0
        if gate.any():
            rel = -0.691 + 10.0 * math.log10(max(z[gate].mean(), 1e-30)) - 10.0
            gate = (loud > rel) & (loud > -70.0)
            if gate.any():
                lufs = -0.691 + 10.0 * math.log10(max(z[gate].mean(), 1e-30))
    energy = float((x * x).sum())
    return {
        "lufs": lufs,
        "true_peak_dbfs": _db(float(np.abs(x).max())),
        "rms_dbfs": _db(math.sqrt(energy / max(valid * x.shape[0], 1))),
    }


def pcm16_scaled(out: torch.Tensor) -> np.ndarray:
    """The 16-bit contract before rounding: clip to ±OUTPUT_CLIP, × 32768
    → (len, C) float64 (the program's int16 lies within 0.5 of it)."""
    x = torch.nan_to_num(out.to(torch.float64), nan=0.0).clamp(-OUTPUT_CLIP, OUTPUT_CLIP)
    return (x * 32768.0).T.cpu().numpy()


def pcm16(out: torch.Tensor) -> np.ndarray:
    """The 16-bit output contract: round half to even, saturate."""
    return np.clip(np.round(pcm16_scaled(out)), -32768, 32767).astype(np.int16)


@contextlib.contextmanager
def few_fft_plans(device, keep: int = 16):
    """Bound the card's cuFFT plan cache while rows of many true lengths
    render: each length makes its own plans, gigabytes of them for long
    Bluestein lengths, and the least recently used go first."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    cache = torch.backends.cuda.cufft_plan_cache[device.index or 0]
    before = cache.max_size
    cache.max_size = min(before, keep)
    try:
        yield
    finally:
        cache.max_size = before

