"""State carried across from the JAX package's host-side objects.

``from_jax_setup`` turns the JAX package's ``models.pipeline.InternalSetup``
into this package's, reading every field as NumPy through ``np.asarray`` and
``._asdict()`` — no JAX import here — so tests can feed identical static
shapes and scalars to both packages.  ``draws_from_numpy`` mirrors the JAX
package's ``ops.ir_synth.draws_to_device`` (the oracle-parity injection).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from audio_raytracing_studio_tpu.params import IRDraws

from ..ops.ir_synth import MAX_REFLECTIONS, IRScalars, IRShape
from .pipeline import InternalSetup, MixScalars, StaticSpec


def _f32_fields(tup) -> dict:
    return {k: np.float32(np.asarray(v)) for k, v in tup._asdict().items()}


def from_jax_setup(setup) -> InternalSetup:
    """JAX ``InternalSetup`` → this package's (``pow2_conv`` is a TPU layout
    flag with no counterpart here and is dropped)."""
    spec = dict(setup.spec._asdict())
    spec.pop("pow2_conv", None)
    return InternalSetup(
        ir_shape=IRShape(**setup.ir_shape._asdict()),
        ir_scalars=IRScalars(**_f32_fields(setup.ir_scalars)),
        mix_scalars=MixScalars(**_f32_fields(setup.mix_scalars)),
        spec=StaticSpec(**spec),
    )


def draws_from_numpy(
    draws: IRDraws, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad host IRDraws to the static tap budget → (delays, strengths, noise)
    tensors on ``device``."""
    n = len(draws.delays)
    if n > MAX_REFLECTIONS:
        # derive_ir_geometry does not clip reflection_count (only the
        # product path's adjust_parameters_for_3d does, ref :224) — a
        # >80-tap injection must fail clearly, not as a broadcast error
        raise ValueError(
            f"injected draws carry {n} early taps; the static budget is "
            f"MAX_REFLECTIONS={MAX_REFLECTIONS} (the reference product path "
            "clips to the same range, raytracer_studio.py:224)"
        )
    delays = np.zeros(MAX_REFLECTIONS, dtype=np.int32)
    strengths = np.zeros(MAX_REFLECTIONS, dtype=np.float32)
    delays[:n] = draws.delays
    strengths[:n] = draws.strengths
    noise = np.asarray(draws.noise, dtype=np.float32)
    if noise.size == 0:
        noise = np.zeros(1, dtype=np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (delays, strengths, noise))
