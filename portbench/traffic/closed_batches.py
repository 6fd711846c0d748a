"""Closed loop of whole batches through ``sharding.render_batch``, paced by
the card.

Set-up makes ``distinct_batches`` batches of ``batch`` clips from the run's
seed straight into page-locked staging (``sharding.staging_clips``), each
row with a render seed of its own and, where the mix pads, a true length
drawn from ``true_length_share`` of the buffer.  Where the configuration's
reference module has ``batch_inputs(run, k, rng)``, each batch also gets
the extra keywords of ``render_batch`` it returns (such as an external IR),
from a generator of the run's seed of their own.  The window cycles through
them, keeping ``in_flight`` batches enqueued on as many CUDA streams
(``render_batch(async_results=True)``): while one batch renders, the next
one's upload and the previous one's copy down ride the copy engines.  A
batch counts once its ``fetch()`` has returned and one of its rows, drawn
from the seed, has been offered to the correctness sample.

The window closes at the first completion at or after ``--seconds``, so it
holds whole batches only; ``audio_rt`` is the audio-seconds of their real
rows over the window's length.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from .. import inputs
from ..harness import Run, Sample, reference
from ..reference import render as ref

# pipelined warm-up rounds after the first batch (each puts ``in_flight``
# more batches through); the control's readings, whose timing nobody reads,
# set it to 0
WARM_ROUNDS = 2


@dataclasses.dataclass
class Batch:
    index: int
    audio: np.ndarray  # (B, n, channels) page-locked staging
    seeds: List[int]
    lengths: Optional[List[int]]
    audio_s: float
    inputs: dict  # extra keywords of render_batch, read-only


class Reservoir:
    """A uniform sample of ``k`` answers out of all offered, drawn from ``rng``."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k, self.seen, self.items = rng, k, 0, []

    def slot(self) -> Optional[int]:
        """The slot the next offer goes to, or None to drop it."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.k else None


def make_batches(run: Run) -> List[Batch]:
    cfg, tr = run.config, run.traffic
    rate, channels = int(cfg["rate"]), int(cfg["input_channels"])
    count, size = int(tr["distinct_batches"]), int(tr["batch"])
    n = int(round(float(tr["clip_seconds"]) * rate))
    rng = np.random.default_rng(run.seed)
    seeds = inputs.distinct_seeds(rng, count * size)
    share = tr.get("true_length_share")
    lengths = None
    if share:
        lengths = np.minimum(np.round(inputs.spread(rng, count * size, share[0] * n,
                                                    share[1] * n)), n).astype(int).tolist()
    from audio_raytracing_studio_tpu_torch.parallel import sharding

    staging = [sharding.staging_clips(size, n, channels, run.device) for _ in range(count)]
    run.mark("staging_alloc")
    batch_inputs = getattr(reference(cfg), "batch_inputs", None)
    extra_rng = np.random.default_rng([run.seed, 2])
    batches = []
    for k, audio in enumerate(staging):
        rows = slice(k * size, (k + 1) * size)
        lens = None if lengths is None else lengths[rows]
        inputs.clips_into(audio, int(rng.integers(2 ** 62)), rate, run.device, lens)
        audio_s = (size * n if lens is None else sum(lens)) / rate
        extra = batch_inputs(run, k, extra_rng) if batch_inputs else {}
        batches.append(Batch(k, audio, seeds[rows], lens, audio_s, extra))
    run.sync()
    run.mark("inputs")
    return batches


def run(run: Run) -> None:
    from audio_raytracing_studio_tpu_torch.parallel import sharding
    from audio_raytracing_studio_tpu_torch.params import RenderParams

    run.mark("import_program")
    cfg, tr = run.config, run.traffic
    rate = int(cfg["rate"])
    params = dict(cfg["params"])
    fast = bool(tr.get("fast_filters", False))
    depth = int(tr.get("in_flight", 2))
    if run.device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=run.device)
    run.mark("cuda_context")
    batches = make_batches(run)
    prm = RenderParams(**params)
    n = batches[0].audio.shape[1]
    padded_eq = any(b.lengths is not None and any(tl != n for tl in b.lengths)
                    for b in batches) and ref.derive(params, rate)["eq_on"]
    run.cell = dict(rate=rate, n_in=n, batch=len(batches[0].seeds), params=params,
                    clip_lengths=batches[0].lengths)
    cuda = run.device.type == "cuda"
    streams = [torch.cuda.Stream(run.device) if cuda else None for _ in range(depth)]

    def dispatch(k: int):
        b = batches[k % len(batches)]
        stream = streams[k % depth]
        with run.span("render_batch"), (torch.cuda.stream(stream) if cuda
                                       else contextlib.nullcontext()):
            fetch = sharding.render_batch(
                b.audio, rate, prm, seeds=b.seeds, clip_lengths=b.lengths,
                with_metrics=True, fast_filters=fast, pcm16_output=True,
                async_results=True, device=run.device, **b.inputs)
        return b, fetch

    # set-up: the kernels' build and the plans at the first batch, then a
    # pipelined pass so that every stream's allocator pool is warm
    first, _ = dispatch(0)[1]()  # (B, len_out, C) int16, one metrics dict per row
    run.sync()
    run.mark("first_batch")
    pending = deque(dispatch(k) for k in range(depth if WARM_ROUNDS else 0))
    for k in range(depth, (1 + WARM_ROUNDS) * depth):
        pending.popleft()[1]()
        pending.append(dispatch(k))
    while pending:
        pending.popleft()[1]()
    run.spans.clear()
    run.setup_done()

    pick = np.random.default_rng([run.seed, 1])
    sample = Reservoir(pick, int(tr["sample_rows"]))
    kept: List[Optional[Sample]] = sample.items
    # the sampled rows' host buffers, touched now so that keeping a row in
    # the window copies it without faulting in fresh pages
    rows = [np.ones_like(first[0]) for _ in range(sample.k)]
    del first
    done_audio, done_rows, k = 0.0, 0, 0
    with run.window():
        t0 = time.perf_counter()
        inflight = deque()
        while True:
            while len(inflight) < depth:
                inflight.append(dispatch(k))
                k += 1
            b, fetch = inflight.popleft()
            with run.span("fetch"):
                out, metrics = fetch()
            with run.span("sample"):
                row = int(pick.integers(len(b.seeds)))
                slot = sample.slot()
                if slot is not None:
                    np.copyto(rows[slot], out[row])
                    kept[slot] = Sample(
                        key=(b.index, row), pcm=rows[slot],
                        metrics=metrics[row],
                        clip=b.audio[row], params=params, seed=b.seeds[row],
                        clip_length=None if b.lengths is None else b.lengths[row],
                        fast=fast, padded_eq=padded_eq, inputs=b.inputs)
            del out, metrics
            done_audio += b.audio_s
            done_rows += len(b.seeds)
            elapsed = time.perf_counter() - t0
            if elapsed >= run.seconds:
                break
        run.counters["clips_done"] = done_rows
        run.counters["batches_done"] = done_rows // len(b.seeds)
    run.read_memory_peak()
    for _, fetch in inflight:  # due after the close: drained, not counted
        fetch()
    run.sync()
    run.attempted = done_rows
    run.samples = [s for s in kept if s is not None]
    run.end_to_end["audio_rt"] = done_audio / elapsed
    streams.clear()
