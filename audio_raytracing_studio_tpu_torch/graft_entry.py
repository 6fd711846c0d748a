"""Entry points for an outside harness — port of the root ``__graft_entry__.py``.

``entry()`` hands out the render step with its static configuration bound
and example inputs; ``dryrun_multichip`` waits for the port's multi-device
rendering (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import functools

import numpy as np


def entry(device="cuda"):
    """(fn, example_args) — the forward render step of the internal hall.

    ``fn`` is ``models.pipeline.internal_graph`` (IR synthesis → batched FFT
    convolution → air absorption → dry/wet mix → pan → layout map) with the
    static configuration bound; ``example_args`` are tensors on ``device``
    for a 0.5 s 48 kHz stereo clip through the default "Room" hall in the
    5.1 (Standard) layout, with the counter-hash draws of seed 0.
    ``fn(*example_args)`` → (1, 6, len_out) float32.
    """
    import torch

    from .models import pipeline
    from .ops import ir_synth
    from .params import RenderParams
    from .utils.runtime import ensure_device

    dev = ensure_device(device)
    rate = 48000
    n_in = rate // 2
    setup = pipeline.build_internal_setup(RenderParams(target_layout="5.1 (Standard)"),
                                          rate, n_in)

    t = np.arange(n_in) / rate
    clip = (0.4 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    audio = torch.from_numpy(np.stack([clip, clip]))[None].to(dev)
    delays, strengths, noise = ir_synth.hash_draws(0, setup.ir_shape, dev)

    fn = functools.partial(pipeline.internal_graph, ir_shape=setup.ir_shape, spec=setup.spec)
    example_args = (
        audio,
        delays,
        strengths,
        noise,
        setup.ir_scalars,
        pipeline.MixScalars.stack([setup.mix_scalars], dev),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int) -> None:
    """The multi-device dry run (the data-parallel batch, the partitioned
    convolution, the sequence-parallel render) needs the port's mesh legs."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}): multi-device rendering is not ported yet "
        "(ROADMAP Queue 1 item 16)"
    )
