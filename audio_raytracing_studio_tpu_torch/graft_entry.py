"""Entry points for an outside harness — port of the root ``__graft_entry__.py``.

``entry()`` hands out the render step with its static configuration bound
and example inputs; ``dryrun_multichip`` runs the multi-device paths (the
data-parallel batch, the partitioned convolution, the sequence-parallel
render) end to end at small sizes.
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


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the multi-device render path end to end at small sizes over
    ``n_devices`` devices (default: the visible cards; ``devices`` may repeat
    one device, e.g. ``["cuda:0"] * 8``), as the JAX package's dry run does:

    1. the data-parallel batch over a data mesh of ``n_devices``, with the
       meter (1); a padded mixed-length batch with shelf EQ and masked
       metrics (1b); the bank with the full option matrix — PCM16, masked
       metrics, padded EQ, ``real_batch`` and ``async_results`` (1c);
    2. the block-partitioned convolution on a (data, block) mesh;
    3. the sequence-parallel ``render_long`` of 1 s at 48 kHz, 7.1, with the
       distributed exact-length EQ and the sharded meter, over a block mesh
       of ``n_devices``.

    Returns what each leg produced (shapes, metrics); raises on any fault.
    """
    import torch

    from .params import RenderParams
    from .parallel import long_render, partitioned_conv, sharding
    from .parallel import mesh as meshlib

    if devices is None:
        devices = meshlib.make_mesh().devices
        devices = [d for row in devices for d in row]
    devices = list(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) but only {len(devices)} devices")
    devices = devices[:n_devices]
    kind = torch.device(devices[0]).type

    def expect(cond: bool, what: str) -> None:
        if not cond:
            raise RuntimeError(f"dryrun_multichip: {what}")

    # factor n_devices into (data, block): the largest block of 4 or 2 dividing it
    block = next((c for c in (4, 2) if n_devices % c == 0), 1)
    data = n_devices // block

    rate = 8000
    n_in = rate // 4  # 0.25 s per clip
    rng = np.random.default_rng(0)
    t = np.arange(n_in) / rate
    report = {"devices": [str(d) for d in devices]}

    # --- 1. data-parallel batched render + metering ---
    data_mesh = meshlib.make_mesh(data=n_devices, block=1, devices=devices)
    batch = 2 * n_devices
    clips = np.stack([(0.3 * np.sin(2 * np.pi * (150.0 + 20 * i) * t)).astype(np.float32)
                      for i in range(batch)])
    p = RenderParams(target_layout="5.1 (Standard)", room_size=40.0)
    out, metrics = sharding.render_batch(clips, rate, p, device_mesh=data_mesh,
                                         with_metrics=True, device=kind)
    expect(out.shape[0] == batch and out.shape[2] == 6, f"batch output {out.shape}")
    expect(len(metrics) == batch, f"{len(metrics)} metric dicts for {batch} clips")
    report["batch"] = list(out.shape)

    # --- 1b. a padded mixed-length batch with EQ: each clip EQ'd and metered
    #         at its true length ---
    p_eq = RenderParams(target_layout="5.1 (Standard)", room_size=40.0,
                        bass_gain=1.6, treble_gain=0.7)
    true_lens = [n_in - (37 * i) % (n_in // 2) for i in range(batch)]
    clips_eq = clips.copy()
    for i, tl in enumerate(true_lens):
        clips_eq[i, tl:] = 0.0
    out_eq, metrics_eq = sharding.render_batch(
        clips_eq, rate, p_eq, device_mesh=data_mesh, with_metrics=True,
        clip_lengths=true_lens, device=kind)
    expect(out_eq.shape[0] == batch and len(metrics_eq) == batch, f"padded EQ {out_eq.shape}")

    # --- 1c. the bank with the full option matrix: PCM16, masked metrics,
    #         padded EQ-on clips, pad rows dropped, results fetched later ---
    fetch = sharding.render_batch(
        clips_eq, rate, p_eq, device_mesh=data_mesh, with_metrics=True,
        clip_lengths=true_lens, ir_backend="bank", pcm16_output=True,
        real_batch=batch - 1, async_results=True, device=kind)
    out_q, metrics_q = fetch()
    expect(out_q.dtype == np.int16 and out_q.shape[0] == batch - 1, f"PCM16 {out_q.shape}")
    expect(len(metrics_q) == batch - 1, f"{len(metrics_q)} PCM16 metric dicts")
    report["lufs"] = [round(m["lufs"], 4) for m in metrics_q[:2]]

    # --- 2. partitioned convolution on a (data, block) mesh ---
    dp_mesh = meshlib.make_mesh(data=data, block=block, devices=devices)
    n_sig, n_ker = 2048, 600
    sig = rng.standard_normal((2, n_sig)).astype(np.float32) * 0.2
    ker = rng.standard_normal((2, n_ker)).astype(np.float32) * 0.05
    n_pad = partitioned_conv.padded_length(n_sig, n_ker, block)
    conv = partitioned_conv.partitioned_convolve(
        np.pad(sig, ((0, 0), (0, n_pad - n_sig))), ker, dp_mesh)
    expect(tuple(conv.shape) == (2, 2, n_pad), f"partitioned conv {tuple(conv.shape)}")
    report["partitioned"] = [data, block]

    # --- 3. sequence-parallel render of one clip over every device: ring
    #        overlap-add, pmax normalizations, the halo delays of the 7.1
    #        sides, the distributed exact EQ, the sharded meter ---
    block_mesh = meshlib.make_mesh(data=1, block=n_devices, devices=devices)
    long_rate = 48000
    t_long = np.arange(1 * long_rate) / long_rate
    clip = (0.3 * np.sin(2 * np.pi * 180.0 * t_long)).astype(np.float32)
    p_long = RenderParams(target_layout="7.1 (Surround)", room_size=40.0, z_pos=0.7,
                          bass_gain=1.5, treble_gain=0.7)
    long_out, long_metrics = long_render.render_long(clip, long_rate, p_long, block_mesh,
                                                     seed=1, with_metrics=True)
    expect(long_out.shape[1] == 8, f"long render {long_out.shape}")
    expect(bool(np.isfinite(long_out).all()), "long render has non-finite samples")
    expect(np.isfinite(long_metrics["lufs"]), f"long render metrics {long_metrics}")
    report["long"] = list(long_out.shape)
    report["long_metrics"] = long_metrics

    print(f"dryrun_multichip OK: {batch} clips over data={n_devices}; "
          f"partitioned conv over (data={data}, block={block}); "
          f"sequence-parallel render over block={n_devices}")
    return report


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
