"""The device an entry point runs on — the port's counterpart of
``ensure_backend`` in ``audio_raytracing_studio_tpu/utils/runtime.py``.

The JAX version probes a TPU plugin out of process and falls back to the
CPU when the accelerator does not answer.  The port never falls back: a
caller that asks for CUDA on a machine without a card gets an error, and
the CPU runs only when the caller names it (``--device cpu`` on the CLIs,
``device="cpu"`` from Python).
"""

from __future__ import annotations

import torch


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
