"""The control: the plain reference put in the program's place, computed
in the next precision below the configuration's float32 (bfloat16 storage
of every stage's result).  It answers ``render_batch``'s call as the
program does, so a run with it in place drives the whole harness, and the
comparison has to find it not correct.  The reference is the one the
cell's configuration names (``render``, the internal hall, by default),
and the batch's extra keywords (such as an external IR) go on to its
``render_row``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import render as ref


def render_batch(audio, rate, params, seeds=None, clip_lengths=None, with_metrics=False,
                 fast_filters=False, pcm16_output=False, real_batch=None,
                 async_results=False, device="cuda", reference=ref, **inputs):
    """``sharding.render_batch``'s contract, answered by ``reference``'s
    ``render_row`` at ``ref.BF16``."""
    audio = np.asarray(audio, np.float32)
    audio = audio[:, :, None] if audio.ndim == 2 else audio
    batch = audio.shape[0]
    plist = list(params) if isinstance(params, (list, tuple)) else [params] * batch
    dicts = [dataclasses.asdict(p) for p in plist]
    seeds = list(range(batch)) if seeds is None else list(seeds)
    n_real = batch if real_batch is None else real_batch
    padded = clip_lengths is not None and any(
        int(tl) != audio.shape[1] and ref.derive(p, rate)["eq_on"]
        for tl, p in zip(clip_lengths, dicts))
    outs, metrics = [], []
    with ref.few_fft_plans(device):
        for i in range(n_real):
            tl = None if clip_lengths is None else clip_lengths[i]
            out, valid = reference.render_row(audio[i], rate, dicts[i], seeds[i], tl,
                                              fast_filters, padded, ref.BF16,
                                              torch.device(device), **inputs)
            outs.append(ref.pcm16(out) if pcm16_output else out.T.float().cpu().numpy())
            metrics.append(ref.meter(out, valid, rate, ref.BF16))
    result = np.stack(outs)
    result = (result, metrics) if with_metrics else result
    return (lambda: result) if async_results else result
