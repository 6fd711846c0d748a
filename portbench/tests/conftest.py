"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes)."""

import pytest
import torch

# several test workers share the cores: keep each one's intra-op pool small
torch.set_num_threads(2)

# a tiny version of every traffic mix: the same code path, sizes a CPU run holds
TINY = dict(batch=2, distinct_batches=2, clip_seconds=0.5, sample_rows=6)


@pytest.fixture
def restore_render_batch():
    """Put the program's render_batch back after a test swaps it."""
    from audio_raytracing_studio_tpu_torch.parallel import sharding

    original = sharding.render_batch
    yield sharding
    sharding.render_batch = original
