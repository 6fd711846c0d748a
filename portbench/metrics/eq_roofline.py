"""The length-dynamic exact shelf EQ's share of its bytes roofline at the
cell's (B, 2, output length) with the cell's true lengths:
``filters.apply_shelf_eq_dynamic`` called alone after the window, its
device time read from a profiler trace of those calls (the program marks no
span around the EQ inside ``render_batch``, and its cuFFT kernels share
their names with the convolution's).  Its contract reads the stereo mix and
writes it filtered (float32), plus a gain pair and four length scalars per
row."""

from portbench.reference import render as ref
from portbench.roofline import share_pct


def read(run):
    c = run.cell
    if run.device.type != "cuda" or not c or not c.get("clip_lengths"):
        return None
    g = ref.derive(c["params"], c["rate"])
    if not g["eq_on"]:
        return None
    import torch

    from audio_raytracing_studio_tpu_torch.ops import filters

    batch, ir_length = c["batch"], g["length"]
    length = c["n_in"] + ir_length - 1
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed % (2 ** 63))
    mixed = torch.randn((batch, 2, length), generator=gen, device=run.device)
    dyn = filters.EQDyn.stack(
        [filters.eq_dyn_host(min(int(tl), c["n_in"]) + ir_length - 1, c["rate"])
         for tl in c["clip_lengths"]], run.device)
    bass = torch.full((batch,), c["params"]["bass_gain"], device=run.device)
    treble = torch.full((batch,), c["params"]["treble_gain"], device=run.device)
    seconds = run.trace_device(lambda: filters.apply_shelf_eq_dynamic(mixed, bass, treble, dyn), 3)
    if seconds is None:
        return None
    nbytes = 2 * batch * 2 * length * 4 + batch * 2 * 4 + batch * 4 * 8
    return share_pct(nbytes, seconds, run.device)
