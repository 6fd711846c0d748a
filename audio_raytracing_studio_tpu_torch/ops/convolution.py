"""FFT linear convolution — port of ``audio_raytracing_studio_tpu/ops/convolution.py``.

The reference's per-channel ``scipy.signal.fftconvolve`` calls
(raytracer_studio.py:362-372) become batched ``torch.fft.rfft``/``irfft``
passes (cuFFT on the GPU) with an explicit batch dimension: signals are
(B, C, N), kernels (B, K, L).  Zero-padding the transform to a fast length
is exact for linear convolution.
"""

from __future__ import annotations

from typing import Optional

import torch


def next_power_of_two(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def fast_fft_length(n: int) -> int:
    """Smallest transform length ≥ n of the form 2^k or 3·2^k.

    The grid is parity-bearing beyond speed: the fast-mode air gain is
    sampled on it (models.pipeline), so it stays the JAX package's rule.
    """
    if n <= 1:
        return 1
    p = next_power_of_two(n)
    m = next_power_of_two((n + 2) // 3)
    return min(p, 3 * m)


def convolve_full(
    signal: torch.Tensor, kernels: torch.Tensor, out_length: int
) -> torch.Tensor:
    """Linear convolution of each channel with each kernel.

    signal (B, C, N), kernels (B, K, L) → (B, K, C, out_length) float32.
    """
    need = max(out_length, signal.shape[-1] + kernels.shape[-1] - 1)
    nfft = fast_fft_length(need)
    sig_f = torch.fft.rfft(signal, n=nfft)  # (B, C, F)
    ker_f = torch.fft.rfft(kernels, n=nfft)  # (B, K, F)
    full = torch.fft.irfft(sig_f[:, None, :, :] * ker_f[:, :, None, :], n=nfft)
    return full[..., :out_length]


def convolve_combined(
    signal: torch.Tensor,
    kernels: torch.Tensor,
    weights: torch.Tensor,
    out_length: int,
    kernel_gains: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Linear convolution with the weighted kernel sum Σ_k w_k·(x ⊛ h_k·g_k).

    Equal by linearity to weighting the per-kernel convolutions, with one
    inverse FFT per channel instead of K.

    signal (B, C, N); kernels (B, K, L); weights (B, K); kernel_gains
    optional (B, K, F) per-bin gains on each kernel's spectrum (F fixes the
    grid).  Returns (B, C, out_length) float32.
    """
    need = max(out_length, signal.shape[-1] + kernels.shape[-1] - 1)
    if kernel_gains is None:
        nfft = fast_fft_length(need)
    else:
        # the gains' bin count fixes the grid: a mismatch is an explicit error
        nfft = 2 * (kernel_gains.shape[-1] - 1)
        if nfft < need:
            raise ValueError(f"kernel_gains imply nfft={nfft} < required {need}")
    sig_f = torch.fft.rfft(signal, n=nfft)  # (B, C, F)
    ker_f = torch.fft.rfft(kernels, n=nfft)  # (B, K, F)
    if kernel_gains is not None:
        ker_f = ker_f * kernel_gains
    combined = (weights[:, :, None] * ker_f).sum(dim=1)  # (B, F)
    full = torch.fft.irfft(sig_f * combined[:, None, :], n=nfft)
    return full[..., :out_length]
