"""State carried across from the JAX package's host-side objects.

Nothing here imports the JAX package: each function reads the object it is
handed through its fields.

- ``from_jax_setup`` turns the JAX package's ``models.pipeline.InternalSetup``
  into this package's, reading every field as NumPy through ``np.asarray``
  and ``._asdict()``, so tests can feed identical static shapes and scalars
  to both packages;
- ``params_from_jax`` and ``draws_from_jax`` turn the JAX package's
  ``RenderParams`` and ``IRDraws`` (frozen dataclasses) into this package's,
  field by field through ``dataclasses.asdict``;
- ``job_from_jax`` turns the JAX package's serving ``RenderJob`` into this
  package's, so tests can hand both render services the same work.

``draws_from_numpy`` mirrors the JAX package's ``ops.ir_synth.draws_to_device``
(the oracle-parity injection for the plain ``synthesize``); ``bank_draws``
packs a list of draws into the injected-draws bank's inputs.  Both read
``.delays``, ``.strengths`` and ``.noise`` through ``np.asarray``, so this
package's ``IRDraws`` and the JAX package's serve alike.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.ir_synth import MAX_REFLECTIONS, IRScalars, IRShape, to_device
from ..ops.ir_synth_cuda import pack_draws
from ..params import IRDraws, RenderParams
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


def params_from_jax(p) -> RenderParams:
    """The JAX package's ``RenderParams`` → this package's (same fields)."""
    return RenderParams(**dataclasses.asdict(p))


def draws_from_jax(d) -> IRDraws:
    """The JAX package's ``IRDraws`` → this package's (same arrays)."""
    return IRDraws(**dataclasses.asdict(d))


def job_from_jax(job):
    """The JAX package's ``serving.RenderJob`` → this package's: the same
    audio and IR arrays (shared, not copied), rate, seed and metrics flag,
    the params through ``params_from_jax``."""
    from ..serving.batcher import RenderJob  # imports this package's pipeline

    return RenderJob(
        audio=job.audio,
        rate=job.rate,
        params=params_from_jax(job.params),
        seed=job.seed,
        with_metrics=job.with_metrics,
        external_ir=job.external_ir,
        external_ir_rate=job.external_ir_rate,
    )


def _check_taps(draws) -> int:
    """Tap count of ``draws``; more than the static budget raises."""
    n = np.asarray(draws.delays).shape[0]
    if n > MAX_REFLECTIONS:
        # derive_ir_geometry does not clip reflection_count (only the
        # product path's adjust_parameters_for_3d does, ref :224) — a
        # >80-tap injection must fail clearly, not as a broadcast error
        raise ValueError(
            f"injected draws carry {n} early taps; the static budget is "
            f"MAX_REFLECTIONS={MAX_REFLECTIONS} (the reference product path "
            "clips to the same range, raytracer_studio.py:224)"
        )
    return n


def draws_from_numpy(
    draws, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad host draws (an ``IRDraws``) to the static tap budget → (delays,
    strengths, noise) tensors on ``device``."""
    n = _check_taps(draws)
    delays = np.zeros(MAX_REFLECTIONS, dtype=np.int32)
    strengths = np.zeros(MAX_REFLECTIONS, dtype=np.float32)
    delays[:n] = np.asarray(draws.delays)
    strengths[:n] = np.asarray(draws.strengths)
    noise = np.asarray(draws.noise, dtype=np.float32)
    if noise.size == 0:
        noise = np.zeros(1, dtype=np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (delays, strengths, noise))


def bank_draws(
    draws: Sequence, shape: IRShape, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``IRDraws`` per bank entry → the injected bank's (delays (B, 80),
    strengths (B, 80), noise (B, max(1, late_length))) tensors on ``device``
    (``ir_synth_cuda.pack_draws``; more than 80 taps raise), copied without
    a host sync (``ir_synth.to_device``)."""
    packed = pack_draws(shape, *([np.asarray(getattr(d, f)) for d in draws]
                                 for f in ("delays", "strengths", "noise")))
    return tuple(to_device(a, device) for a in packed)
