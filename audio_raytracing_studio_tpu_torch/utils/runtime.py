"""The device an entry point runs on — the port's counterpart of
``ensure_backend`` in ``audio_raytracing_studio_tpu/utils/runtime.py``.

The JAX version probes a TPU plugin out of process and falls back to the
CPU when the accelerator does not answer.  The port never falls back: a
caller that asks for CUDA on a machine without a card gets an error, and
the CPU runs only when the caller names it (``--device cpu`` on the CLIs,
``device="cpu"`` from Python).

The application surfaces whose reference signatures carry no ``device``
argument (``app.api``, the studio's handlers, ``compat`` when ``device`` is
left ``None``) run on one process-wide default: ``default_device()``, which
is ``"cuda"`` unless the environment variable ``ARS_TORCH_DEVICE`` named
another device when it was first read, or ``set_default_device`` was called.
"""

from __future__ import annotations

import os
import threading

import torch

_default_lock = threading.Lock()
_default_device = None  # resolved at first use, under the lock


def ensure_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a card raises
    ``RuntimeError``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu on the "
            "command line, or device='cpu' from Python, for the plain PyTorch path"
        )
    return dev


def fft_plan_cache(dev: torch.device):
    """The cuFFT plan cache of a CUDA device (the current device when
    ``dev`` names no index)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch.backends.cuda.cufft_plan_cache[index]


def default_device() -> str:
    """The process-wide device of the surfaces without a ``device`` argument.

    ``ARS_TORCH_DEVICE`` is read once, at the first call; later changes of the
    environment are not seen (use ``set_default_device``).  The name is not
    validated here: callers pass it through ``ensure_device``, which raises
    for CUDA without a card.
    """
    global _default_device
    with _default_lock:
        if _default_device is None:
            _default_device = os.environ.get("ARS_TORCH_DEVICE", "").strip() or "cuda"
        return _default_device


def set_default_device(device) -> str:
    """Set the process-wide default (``None`` forgets it, so that the next
    ``default_device()`` reads ``ARS_TORCH_DEVICE`` again); returns the
    previous setting, which may be ``None``."""
    global _default_device
    with _default_lock:
        previous = _default_device
        _default_device = None if device is None else str(device)
        return previous


def resolve_device(device=None) -> torch.device:
    """``device`` — or the process-wide default when it is ``None`` — through
    ``ensure_device``."""
    return ensure_device(default_device() if device is None else device)
