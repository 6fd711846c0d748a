"""How far the back half's kernel calls per ``render_batch`` call in the
window are from one: |k − 1|, where k is the program's counter
``ars.back_half_kernels`` (one per back half that ran the CUDA kernels of
``csrc/back_half.cu``) over its ``ars.render_batch`` calls.  Right reads 0;
the plain PyTorch back half on the card (no kernel call, so no counter)
reads 1, and so do two calls a batch, so no wrong count reads better than
right.  None off a card and on a program without the kernels (one older than
``ops/back_half_cuda``)."""

import importlib.util

import torch

from portbench import program_spans

MODULE = "audio_raytracing_studio_tpu_torch.ops.back_half_cuda"


def read(run):
    if torch.device(run.device).type != "cuda":
        return None
    per_call = program_spans.count_per_call("ars.back_half_kernels", "ars.render_batch")
    if per_call is None:
        row = program_spans.table().get("ars.render_batch")
        if not row or not row["calls"] or importlib.util.find_spec(MODULE) is None:
            return None
        per_call = 0.0  # the program has the kernels, and no call took them
    return abs(per_call - 1.0)
