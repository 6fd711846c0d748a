"""Fourier resampling — port of ``resample_fft`` in
``audio_raytracing_studio_tpu/ops/resample.py``.

``scipy.signal.resample``'s semantics (spectrum truncation or zero-padding,
the unpaired-Nyquist-bin rule) with ``torch.fft`` at the exact input and
output lengths — the method the reference applies to external IRs
(raytracer_studio.py:1037-1040).  cuFFT and pocketfft take any length, so the
JAX package's Bluestein transforms are not needed.
"""

from __future__ import annotations

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
