"""Sample-rate conversion — port of ``audio_raytracing_studio_tpu/ops/resample.py``.

``resample_fft``: ``scipy.signal.resample``'s semantics (spectrum
truncation or zero-padding, the unpaired-Nyquist-bin rule) with ``torch.fft``
at the exact input and output lengths — the method the reference applies to external IRs
(raytracer_studio.py:1037-1040).  cuFFT and pocketfft take any length, so the
JAX package's Bluestein transforms are not needed.

``resample_poly``: polyphase windowed-sinc conversion by up/down, the
analyzer's ``convert --samplerate``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def resample_fft(x, num: int) -> torch.Tensor:
    """Fourier-resample the leading axis of (n,) or (n, C) float32 to ``num``
    samples → a float32 tensor on the input's device (NumPy input: the CPU).

    Keeps the ``min(num, n)//2 + 1`` lowest rfft bins, doubles (down) or
    halves (up) the unpaired bin at ``m//2`` when ``m = min(num, n)`` is even,
    inverse-transforms at the new length and scales by ``num/n``.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    n = int(x.shape[0])
    num = int(num)
    if n < 2 or num < 1:
        raise ValueError(f"cannot resample {n} samples to {num}")
    if num == n:
        return x
    m = min(num, n)
    spec = torch.fft.rfft(x, n=n, dim=0)[: m // 2 + 1]
    if m % 2 == 0:  # the unpaired bin at m//2
        spec[m // 2] *= 2.0 if num < n else 0.5
    out = torch.fft.irfft(spec, n=num, dim=0)  # zero-pads the spectrum when num > n
    return out * (num / n)


@functools.lru_cache(maxsize=32)
def _kaiser_sinc_filter(up: int, down: int, half_width: int, beta: float):
    """Host-designed lowpass prototype for L=up / M=down conversion.

    Kaiser-windowed sinc at cutoff ``1/max(up, down)`` (normalized to the
    upsampled Nyquist), ``2·half_width·max(up, down) + 1`` taps, unit DC
    gain scaled by ``up`` to preserve amplitude through zero-stuffing.
    Returns float32 NumPy and the half length.
    """
    max_rate = max(up, down)
    half_len = half_width * max_rate
    k = np.arange(-half_len, half_len + 1, dtype=np.float64)
    cutoff = 1.0 / max_rate  # fraction of the upsampled Nyquist
    h = cutoff * np.sinc(cutoff * k)
    h *= np.kaiser(2 * half_len + 1, beta)
    h /= h.sum()  # exact unit DC gain
    return (h * up).astype(np.float32), half_len


@functools.lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int, half_width: int):
    """The prototype split into its ``up`` phases, each shifted to a common
    input origin → ((up, 1, taps) float32 weights, origin).

    Output ``m = q·up + s`` of the zero-stuffed, filtered, decimated signal
    is ``Σ_k h[k] · u[m·down + k − half_len]``, and only every ``up``-th
    sample of ``u`` is non-zero: ``u[i·up] = x[i]``.  Its taps are
    ``h[φ_s + r·up]`` on ``x[q·down + o_s + r]``, with ``o_s =
    ceil((s·down − half_len)/up)`` and ``φ_s = o_s·up − (s·down − half_len)``,
    the same for every q.  Row s of the bank holds them at offset
    ``o_s − origin``, so one strided correlation computes every phase.
    """
    h, half_len = _kaiser_sinc_filter(up, down, half_width, 8.555)
    k = h.shape[0]
    starts = [-((half_len - s * down) // up) for s in range(up)]  # o_s = ceil(...)
    origin = min(starts)
    rows = []
    for s, o_s in enumerate(starts):
        phase = o_s * up - (s * down - half_len)
        rows.append((o_s - origin, h[phase:k:up]))
    taps = max(off + len(r) for off, r in rows)
    bank = np.zeros((up, 1, taps), dtype=np.float32)
    for s, (off, r) in enumerate(rows):
        bank[s, 0, off : off + len(r)] = r
    return bank, origin


def resample_poly(x, rate_out: int, rate_in: int, half_width: int = 10) -> torch.Tensor:
    """Polyphase-resample the leading axis of (n,) or (n, C) float32 from
    ``rate_in`` to ``rate_out`` → a float32 tensor on the input's device
    (NumPy input: the CPU).

    The JAX package's form (``ops/resample.py:92-135``): a Kaiser-windowed
    sinc (``half_width`` zero crossings per side, −80 dB stopband) over the
    input zero-stuffed by ``up`` and decimated by ``down``; output length
    ``ceil(n · up / down)``.  Here only the kept outputs are computed: one
    ``conv1d`` of the input with the ``up`` phases of the filter as output
    channels, stride ``down`` — no zero-stuffed buffer (at 44.1 → 48 kHz it
    would be 160× the input).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n = int(x.shape[0])
    if n < 2 or rate_in <= 0 or rate_out <= 0:
        raise ValueError(f"cannot resample {n} samples {rate_in}→{rate_out}")
    g = math.gcd(int(rate_in), int(rate_out))
    up, down = int(rate_out) // g, int(rate_in) // g
    if up == down:
        return x[:, 0] if squeeze else x
    n_out = -(-n * up // down)  # ceil
    bank_np, origin = _polyphase_bank(up, down, half_width)
    bank = torch.from_numpy(bank_np).to(x.device)
    q_count = -(-n_out // up)
    span = (q_count - 1) * down + bank.shape[-1]  # input samples the last row reads
    # x_ext[j] = x[j + origin], zero outside [0, n)
    left = max(0, -origin)
    right = max(0, span + origin - n)
    x_ext = torch.nn.functional.pad(x.T[:, None, :], (left, right))
    x_ext = x_ext[..., max(0, origin) : max(0, origin) + span]
    # TF32 would swamp the −80 dB stopband (the JAX package asks for
    # Precision.HIGHEST for the same reason); the caller's setting comes back
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = torch.nn.functional.conv1d(x_ext, bank, stride=down)  # (C, up, q_count)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = y.transpose(1, 2).reshape(x.shape[1], q_count * up)[:, :n_out].T
    return out[:, 0] if squeeze else out
