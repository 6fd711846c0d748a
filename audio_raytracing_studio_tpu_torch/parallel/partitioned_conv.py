"""Block-partitioned overlap-add convolution across a mesh axis — port of
``audio_raytracing_studio_tpu/parallel/partitioned_conv.py``.

A long clip is split into equal sample blocks along the "block" axis; every
shard convolves its block against the (replicated) kernels with a local
FFT, then the length-(L−1) overlap tails ride a ring of ``ppermute``s to the
downstream shards and are added in.  Per-shard FFT size and memory stay flat
as the clip grows with the mesh, and every hop is neighbour to neighbour.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from ..ops import convolution
from . import mesh as meshlib


def _ring_overlap_add(axis: meshlib.Axis, local_outs: List[torch.Tensor],
                      tails: List[torch.Tensor], block_len: int,
                      wrap: bool = True) -> List[torch.Tensor]:
    """Shift conv tails downstream around the ring and accumulate.

    ``local_outs[k]``: (..., block_len) — shard k's in-block samples;
    ``tails[k]``: (..., L−1) — what shard k's convolution spills past its
    block.  After ceil((L−1)/block_len) hops every spilled sample has landed
    on the shard that owns its output position.  Wrap-around from the last
    shard reaches only zero-padded ghost blocks when the grid is padded by
    the kernel tail; callers whose signal runs to the end of the grid (the
    sharded meter's K-weighting FIR) pass ``wrap=False``: spill arriving
    back at shard 0 is dropped, which makes the result the truncated linear
    convolution instead of the circular one.
    """
    tail_len = tails[0].shape[-1]
    steps = max(0, math.ceil(tail_len / block_len))
    perm = meshlib.ring(axis)
    outs = list(local_outs)
    for _ in range(steps):
        tails = meshlib.ppermute(axis, tails, perm)
        if not wrap:
            # shard 0 has no upstream predecessor in linear order: what it
            # receives came around the ring — drop it, and with the carried
            # tail everything it would pass on
            with axis.on(0):
                tails[0] = torch.zeros_like(tails[0])
        for k in range(axis.size):
            with axis.on(k):
                chunk = tails[k][..., :block_len]
                outs[k] = outs[k] + F.pad(chunk, (0, block_len - chunk.shape[-1]))
                remainder = tails[k][..., block_len:]
                # the carried tail keeps a fixed shape across hops (zero-padded)
                tails[k] = F.pad(remainder, (0, tail_len - remainder.shape[-1]))
    return outs


def padded_length(n_in: int, ir_length: int, num_blocks: int) -> int:
    """Total (host-padded) signal length: a multiple of num_blocks covering N+L−1."""
    needed = n_in + ir_length - 1
    block = math.ceil(needed / num_blocks)
    return block * num_blocks


def partitioned_convolve(
    signal_cn,
    kernels,
    device_mesh: meshlib.Mesh,
    axis_name: str = meshlib.BLOCK_AXIS,
) -> torch.Tensor:
    """Convolve (C, N) with (K, L) kernels, N sharded over the mesh axis.

    N must already be padded to a multiple of the axis size and to at least
    N_signal + L − 1 (see ``padded_length``); the trailing pad must be zeros.
    Tensors (or arrays) may lie anywhere; the result is (K, C, N) on the
    axis's first device — the linear convolution of the unpadded signal
    lives in the first N_signal + L − 1 samples.
    """
    axis = device_mesh.axis(axis_name)
    signal_cn = torch.as_tensor(signal_cn)
    kernels = torch.as_tensor(kernels)
    n_total = signal_cn.shape[-1]
    if n_total % axis.size:
        raise ValueError(f"signal length {n_total} not divisible by {axis.size}")
    block_len = n_total // axis.size
    l = kernels.shape[-1]
    blocks = meshlib.scatter(axis, signal_cn, dim=-1)
    kers = meshlib.replicate(axis, kernels)
    local_outs, tails = [], []
    for k in range(axis.size):
        with axis.on(k):
            # (1, C, b) ⊛ (1, K, L) → (K, C, b + L − 1)
            conv = convolution.convolve_full(blocks[k][None], kers[k][None], block_len + l - 1)[0]
            local_outs.append(conv[..., :block_len])
            tails.append(conv[..., block_len:])
    outs = _ring_overlap_add(axis, local_outs, tails, block_len)
    return meshlib.gather(axis, outs, dim=-1)
