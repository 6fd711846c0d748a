"""The port's IR synthesis (ops/ir_synth.py) and RIR bank (ops/ir_synth_cuda.py)
against the JAX package, on the CPU.

Tolerances:
- counter-hash draws: bit-equal (integer arithmetic, exact bit-cast);
- IRs: ≤ 2e-5 max-abs — float32 round-off of the std/peak reductions in
  another order (IRs peak at 0.9 / 0.7), the bound the JAX package's own
  Pallas and jnp backends meet (tests/test_pallas_rir.py).
The JAX bank runs in interpret mode, as tests/test_pallas_rir.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.ops import ir_synth as jir
from audio_raytracing_studio_tpu.ops.ir_synth_pallas import fused_rir_bank as jax_bank
from audio_raytracing_studio_tpu.params import (
    RenderParams,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
)
from audio_raytracing_studio_tpu_torch.ops import ir_synth as tir
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.utils import kernels

torch.set_num_threads(1)

IR_TOL = 2e-5
SEEDS = [0, 5, 2**31, 0xFFFFFFFF]


def geometry(p: RenderParams, rate: int):
    dur, refs, maxd, split = adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    direc = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    return derive_ir_geometry(rate, dur, refs, maxd, p.material, direc, split, p.diffusion)


GEOMETRIES = {
    # 16 kHz Room: one JAX block, six port tiles
    "room16k": lambda: geometry(RenderParams(), 16000),
    # Cathedral at room_size 600, 16 kHz: 115k samples, four JAX blocks
    "cathedral16k": lambda: geometry(RenderParams(hall_type="Cathedral", room_size=600.0), 16000),
    # smallest geometry: no smoothing (width 1)
    "plate_tiny": lambda: geometry(
        RenderParams(hall_type="Plate", room_size=10.0, diffusion=0.0), 8000
    ),
    # split_point 1, length an exact tile multiple (tile-edge smoothing)
    "split1": lambda: derive_ir_geometry(16000, 4096 / 16000, 25, 0.06, "Holz", 0.5,
                                         1.0 / 16000, 0.5),
}


def shapes(name):
    g = GEOMETRIES[name]()
    return (tir.IRShape.from_geometry(g), tir.IRScalars.from_geometry(g),
            jir.IRShape.from_geometry(g), jir.IRScalars.from_geometry(g))


def test_shape_and_scalars_match_jax():
    for name in GEOMETRIES:
        t_shape, t_sc, j_shape, j_sc = shapes(name)
        assert t_shape._asdict() == j_shape._asdict()
        for a, b in zip(t_sc, j_sc):
            assert np.float32(a) == np.asarray(b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["room16k", "cathedral16k"])
def test_hash_draws_bit_equal(name, seed):
    t_shape, _, j_shape, _ = shapes(name)
    got = [a.numpy() for a in tir.hash_draws(seed, t_shape)]
    want = [np.asarray(a) for a in jir.hash_draws(seed, j_shape)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_synthesize_matches_jax_same_draws(rng, name):
    t_shape, t_sc, j_shape, j_sc = shapes(name)
    hi = max(2, t_shape.actual_max_early_delay)
    delays = rng.integers(1, hi, size=tir.MAX_REFLECTIONS).astype(np.int32)
    strengths = rng.uniform(0.3, 0.8, size=tir.MAX_REFLECTIONS).astype(np.float32)
    noise = rng.uniform(-1, 1, size=max(1, t_shape.late_length)).astype(np.float32)
    je, jl = jir.synthesize(j_shape, jnp.asarray(delays), jnp.asarray(strengths),
                            jnp.asarray(noise), j_sc)
    te, tl = tir.synthesize(t_shape, torch.from_numpy(delays), torch.from_numpy(strengths),
                            torch.from_numpy(noise), t_sc)
    assert te.shape == (t_shape.length,) and tl.dtype == torch.float32
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=IR_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=IR_TOL)


@pytest.mark.parametrize(
    "name, seeds",
    [("room16k", [5, 6]), ("cathedral16k", [42, 2**31])],
)
def test_plain_bank_matches_jax_pallas_bank(name, seeds):
    """Port bank (plain path on CPU tensors) vs the JAX Pallas bank in
    interpret mode, same seeds — single-tile and multi-tile shapes."""
    t_shape, t_sc, j_shape, j_sc = shapes(name)
    carrier = tir.seeds_to_int32(seeds)
    je, jl = map(np.asarray, jax_bank(carrier, j_shape, j_sc, interpret=True))
    before = bank.launch_count
    te, tl = bank.fused_rir_bank(torch.from_numpy(carrier), t_shape, t_sc)
    assert bank.launch_count == before  # the plain path never counts
    assert te.shape == (len(seeds), t_shape.length)
    np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=IR_TOL)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=IR_TOL)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_bank_matches_synthesize_on_hash_draws(name):
    """Bank and per-entry synthesize draw the same stream: same IRs."""
    t_shape, t_sc, _, _ = shapes(name)
    te, tl = bank.fused_rir_bank(torch.from_numpy(tir.seeds_to_int32(SEEDS)), t_shape, t_sc)
    for i, seed in enumerate(SEEDS):
        e, l = tir.synthesize(t_shape, *tir.hash_draws(seed, t_shape), t_sc)
        np.testing.assert_allclose(te[i].numpy(), e.numpy(), rtol=0, atol=IR_TOL)
        np.testing.assert_allclose(tl[i].numpy(), l.numpy(), rtol=0, atol=IR_TOL)


def test_bank_norms_and_structure():
    t_shape, t_sc, _, _ = shapes("cathedral16k")
    e, l = bank.fused_rir_bank(torch.arange(4, dtype=torch.int32), t_shape, t_sc)
    assert not torch.equal(e[0], e[1]) and not torch.equal(l[0], l[1])
    np.testing.assert_allclose(e.abs().amax(1).numpy(), 0.9, atol=1e-4)
    np.testing.assert_allclose(l.abs().amax(1).numpy(), 0.7, atol=1e-4)
    assert not e[:, t_shape.split_point:].any()
    assert not l[:, : t_shape.split_point].any()
    assert not e[:, 0].any()


def test_plain_bank_stats_per_tile():
    """Raw stats keep the kernel's meaning: valid counts sum to late_length,
    tiles past the tail are empty."""
    t_shape, t_sc, _, _ = shapes("room16k")
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    _, _, stats = bank._rir_block_plain(seeds, t_sc.table(2, "cpu"), t_shape)
    assert stats.shape == (2, bank.n_tiles(t_shape), bank.N_STATS)
    assert stats[:, :, 6].sum(1).tolist() == [t_shape.late_length] * 2
    assert (stats[:, :, 1] >= 0).all() and (stats[:, :, 3] >= 0).all()
    assert not stats[:, :, 7].any()


class TestFinalizeVarianceRobustness:
    """The bank's variance restore survives a large-mean signal: per-tile
    (sum, centered M2, n) combine by Chan's formula (analogue of the JAX
    package's TestFinalizeVarianceRobustness; float64 truth, rel 1e-3)."""

    @staticmethod
    def _stats(blocks, scale):
        n_blocks, block = blocks.shape
        stats = np.zeros((1, n_blocks, bank.N_STATS), np.float32)
        for i, b in enumerate(blocks):
            s = np.float32(b.sum(dtype=np.float32))
            stats[0, i, 0] = s
            stats[0, i, 1] = np.square(b - s / np.float32(block), dtype=np.float32).sum(
                dtype=np.float32)
            h = (scale * b).astype(np.float32)
            hs = np.float32(h.sum(dtype=np.float32))
            stats[0, i, 2] = hs
            stats[0, i, 3] = np.square(h - hs / np.float32(block), dtype=np.float32).sum(
                dtype=np.float32)
            stats[0, i, 5] = np.abs(h).max()
            stats[0, i, 6] = block
        return stats

    @pytest.mark.parametrize(
        "mean, std, scale, rel",
        [(100.0, 0.01, 0.5, 1e-3), (0.0, 1.0, 0.25, 1e-4)],
    )
    def test_chan_combination_matches_float64(self, mean, std, scale, rel):
        data = (mean + std * np.random.default_rng(0).standard_normal(8 * 4096)).astype(
            np.float32)
        stats = self._stats(data.reshape(8, 4096), scale)
        shape = tir.IRShape(length=data.size + 1, split_point=1, actual_max_early_delay=1,
                            reflection_count=0, late_length=data.size,
                            noise_smooth_width=5, early_taps_active=False)
        _, late = bank._finalize_bank(torch.zeros(1, 1), torch.ones(1, 1),
                                      torch.from_numpy(stats), shape)
        c_true = np.std(data.astype(np.float64)) / np.std(scale * data.astype(np.float64))
        max_t = float(stats[0, :, 5].max())
        assert float(late[0, 0]) == pytest.approx(c_true * (0.7 / (max_t * c_true)), rel=rel)


class TestNoSilentFallback:
    """A CUDA request never lands on the plain path or the CPU."""

    def test_non_cpu_tensor_never_takes_plain_path(self, monkeypatch):
        t_shape, t_sc, _, _ = shapes("room16k")

        def forbidden(*args, **kwargs):
            raise AssertionError("plain path taken for a non-CPU tensor")

        monkeypatch.setattr(bank, "_rir_block_plain", forbidden)
        with pytest.raises(ValueError, match="cuda or cpu"):
            bank.fused_rir_bank(torch.zeros(2, dtype=torch.int32, device="meta"), t_shape, t_sc)

    def test_kernel_wrapper_rejects_cpu_tensors(self):
        t_shape, t_sc, _, _ = shapes("room16k")
        with pytest.raises(ValueError, match="CUDA device"):
            bank._rir_block_cuda(torch.zeros(2, dtype=torch.int32), t_sc.table(2, "cpu"), t_shape)

    def test_cuda_request_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the CUDA-less case")
        from audio_raytracing_studio_tpu_torch.models import pipeline
        from audio_raytracing_studio_tpu_torch.parallel import sharding

        x = np.zeros(800, np.float32)
        p = RenderParams(target_layout="Stereo")
        with pytest.raises(RuntimeError, match="cuda"):
            pipeline.render(x, 8000, p, seed=1, device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            sharding.render_batch(x[None], 8000, p, device="cuda")

    def test_build_raises_without_nvcc(self, monkeypatch, tmp_path):
        import torch.utils.cpp_extension as cpp_ext

        monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.build("rir_bank")
        assert not list(tmp_path.iterdir())

    def test_build_surfaces_nvcc_errors(self, monkeypatch, tmp_path):
        fake = tmp_path / "bin" / "nvcc"
        fake.parent.mkdir()
        fake.write_text("#!/bin/sh\necho 'rir_bank.cu(1): error: simulated' >&2\nexit 2\n")
        fake.chmod(0o755)
        monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(kernels.shutil, "which", lambda name: str(fake))
        with pytest.raises(RuntimeError, match="simulated"):
            kernels.build("rir_bank")
        assert not list((tmp_path / "build").iterdir())  # no half-written library
