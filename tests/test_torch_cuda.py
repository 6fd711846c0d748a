"""Checks that need an NVIDIA GPU and nvcc: the CUDA RIR-bank kernel against
its plain PyTorch version on the card, and the render path through it.

Marked ``cuda``; each test skips (with a reason) where no card is present,
as on a CPU-only machine.  This file imports no JAX, so on the GPU machine it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: 2e-5 max-abs on the finalized IRs (peaks 0.9 / 0.7) — float
round-off of reductions summed in another order, and of expf/powf ulps.
"""

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.ops import ir_synth
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.parallel import sharding

pytestmark = pytest.mark.cuda

BANK_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("hall, room, rate", [
    ("Room", 100.0, 16000),
    ("Room", 100.0, 48000),
    ("Cathedral", 600.0, 48000),
    ("Plate", 10.0, 8000),
])
def test_bank_kernel_matches_plain(cuda, hall, room, rate):
    setup = pipeline.build_internal_setup(RenderParams(hall_type=hall, room_size=room), rate, 100)
    seeds = [0, 1, 7, 2**31, 0xFFFFFFFF]
    seeds_t = torch.from_numpy(ir_synth.seeds_to_int32(seeds)).to(cuda)
    scal = setup.ir_scalars.table(len(seeds), cuda)
    before = bank.launch_count
    raw_k = bank._rir_block_cuda(seeds_t, scal, setup.ir_shape)
    raw_p = bank._rir_block_plain(seeds_t, scal, setup.ir_shape)
    torch.cuda.synchronize()
    assert bank.launch_count == before + 1
    assert raw_k[2].shape == raw_p[2].shape
    assert torch.equal(raw_k[2][..., 6], raw_p[2][..., 6])  # valid counts are exact
    fin_k = bank._finalize_bank(*raw_k, setup.ir_shape)
    fin_p = bank._finalize_bank(*raw_p, setup.ir_shape)
    for k, p in zip(fin_k, fin_p):
        assert (k - p).abs().max().item() <= BANK_TOL


def test_render_batch_launches_kernel_once(cuda):
    rate = 16000
    t = np.arange(rate // 2) / rate
    clips = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 40 * i) * t)).astype(np.float32)
                      for i in range(3)])
    p = RenderParams(target_layout="Stereo")
    for fast in (True, False):
        before = bank.launch_count
        out = sharding.render_batch(clips, rate, p, seeds=[1, 2, 2**31], fast_filters=fast,
                                    device=cuda)
        assert bank.launch_count == before + 1
        ref = sharding.render_batch(clips, rate, p, seeds=[1, 2, 2**31], fast_filters=fast,
                                    device="cpu")
        assert float(np.abs(out - ref).max()) <= 1e-4
