"""Audio Raytracing Studio — PyTorch / CUDA port.

Port of ``audio_raytracing_studio_tpu/__init__.py``.  The JAX package stays
the reference; this package renders the same audio with PyTorch tensors on
an NVIDIA GPU (``device="cuda"``, the default) or on the CPU
(``device="cpu"``, the plain-PyTorch path the tests drive).  The fused
RIR bank is a hand-written CUDA kernel (``csrc/rir_bank.cu``), built with
nvcc at first use.

Host-side constants and the float64 parameter math (``config``,
``params``, ``metering.kweighting``) are this package's own copies of the
JAX package's modules: the port imports nothing of the JAX package.
"""

from . import config
from .params import IRDraws, IRGeometry, RenderParams

__version__ = "0.1.0"

__all__ = [
    "config",
    "RenderParams",
    "IRGeometry",
    "IRDraws",
    "render",
    "render_batch",
    "__version__",
]


def render(*args, **kwargs):
    """Single-clip render — see models.pipeline.render (lazy import)."""
    from .models.pipeline import render as _render

    return _render(*args, **kwargs)


def render_batch(*args, **kwargs):
    """Batched render — see parallel.sharding.render_batch (lazy import)."""
    from .parallel.sharding import render_batch as _render_batch

    return _render_batch(*args, **kwargs)
