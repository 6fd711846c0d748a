"""The port's IR synthesis (ops/ir_synth.py) and RIR bank (ops/ir_synth_cuda.py)
against the JAX package, on the CPU — hash draws and injected draws.

Tolerances:
- counter-hash draws: bit-equal (integer arithmetic, exact bit-cast);
- IRs: ≤ 2e-5 max-abs — float32 round-off of the std/peak reductions in
  another order (IRs peak at 0.9 / 0.7), the bound the JAX package's own
  Pallas and jnp backends meet (tests/test_pallas_rir.py).
The JAX bank runs in interpret mode, as tests/test_pallas_rir.py runs it.
Each geometry is derived twice, by the JAX package's ``params`` for the JAX
side and by the port's own copy for the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu import params as jparams
from audio_raytracing_studio_tpu.ops import ir_synth as jir
from audio_raytracing_studio_tpu.ops.ir_synth_pallas import fused_rir_bank as jax_bank
from audio_raytracing_studio_tpu.ops.ir_synth_pallas import pack_draws as jax_pack_draws
from audio_raytracing_studio_tpu_torch import params as tparams
from audio_raytracing_studio_tpu_torch.ops import ir_synth as tir
from audio_raytracing_studio_tpu_torch.ops import ir_synth_cuda as bank
from audio_raytracing_studio_tpu_torch.utils import kernels

torch.set_num_threads(1)

IR_TOL = 2e-5
SEEDS = [0, 5, 2**31, 0xFFFFFFFF]


def geometry(p, rate: int, m=tparams):
    """IRGeometry of RenderParams ``p`` by the params module ``m``."""
    dur, refs, maxd, split = m.adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    direc = m.compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    return m.derive_ir_geometry(rate, dur, refs, maxd, p.material, direc, split, p.diffusion)


GEOMETRIES = {  # each: params module → IRGeometry
    # 16 kHz Room: one JAX block, six port tiles
    "room16k": lambda m: geometry(m.RenderParams(), 16000, m),
    # Cathedral at room_size 600, 16 kHz: 115k samples, four JAX blocks
    "cathedral16k": lambda m: geometry(m.RenderParams(hall_type="Cathedral", room_size=600.0),
                                       16000, m),
    # smallest geometry: no smoothing (width 1)
    "plate_tiny": lambda m: geometry(
        m.RenderParams(hall_type="Plate", room_size=10.0, diffusion=0.0), 8000, m
    ),
    # split_point 1, length an exact tile multiple (tile-edge smoothing)
    "split1": lambda m: m.derive_ir_geometry(16000, 4096 / 16000, 25, 0.06, "Holz", 0.5,
                                             1.0 / 16000, 0.5),
    # the bench shape: 48 kHz Room, 72,000 samples, 18 tiles
    "room48k": lambda m: geometry(m.RenderParams(), 48000, m),
}


def shapes(name):
    g, jg = GEOMETRIES[name](tparams), GEOMETRIES[name](jparams)
    return (tir.IRShape.from_geometry(g), tir.IRScalars.from_geometry(g),
            jir.IRShape.from_geometry(jg), jir.IRScalars.from_geometry(jg))


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


def make_draws(rng, shape, batch):
    """Per-entry explicit draws, as tests/test_pallas_rir.py makes them."""
    hi = max(2, shape.actual_max_early_delay)
    delays = rng.integers(1, hi, size=(batch, tir.MAX_REFLECTIONS)).astype(np.int32)
    strengths = rng.uniform(0.3, 0.8, size=(batch, tir.MAX_REFLECTIONS)).astype(np.float32)
    noise = rng.uniform(-1, 1, size=(batch, max(1, shape.late_length))).astype(np.float32)
    return delays, strengths, noise


def alternating_noise(n, amplitude=1e-4):
    """±amplitude alternating noise: the 10-tap average cancels it inside the
    tail, so std(smoothed) ≤ 1e-6 — synthesize's raw-noise fallback."""
    return np.where(np.arange(n) % 2 == 0, amplitude, -amplitude).astype(np.float32)


# (geometry, batch, degenerate entry 0, also against JAX's interpreted bank)
INJECTED_CASES = {
    "room16k_b2": ("room16k", 2, False, True),
    "split1": ("split1", 1, False, True),
    "cathedral16k_multitile": ("cathedral16k", 2, False, False),
    "room48k_degenerate": ("room48k", 2, True, True),
}


@pytest.mark.parametrize("case", sorted(INJECTED_CASES))
def test_injected_plain_bank_matches_jax(rng, case):
    """``_rir_bank_plain`` (through ``fused_rir_bank(..., injected_draws=...)``
    on CPU tensors) against JAX ``synthesize`` per entry and against JAX's
    injected Pallas bank in interpret mode, identical draws (≤ 2e-5;
    measured ≤ 1.2e-7)."""
    name, batch, degenerate, vs_interpret = INJECTED_CASES[case]
    t_shape, t_sc, j_shape, j_sc = shapes(name)
    delays, strengths, noise = make_draws(rng, t_shape, batch)
    if degenerate:
        noise[0] = alternating_noise(noise.shape[1])
    before = bank.injected_launch_count
    te, tl = bank.fused_rir_bank(torch.zeros(batch, dtype=torch.int32), t_shape, t_sc,
                                 injected_draws=bank.pack_draws(t_shape, delays, strengths,
                                                                noise))
    assert bank.injected_launch_count == before  # the plain path never counts
    assert te.shape == tl.shape == (batch, t_shape.length)
    for b in range(batch):
        je, jl = jir.synthesize(j_shape, jnp.asarray(delays[b]), jnp.asarray(strengths[b]),
                                jnp.asarray(noise[b]), j_sc)
        np.testing.assert_allclose(te[b].numpy(), np.asarray(je), rtol=0, atol=IR_TOL)
        np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl), rtol=0, atol=IR_TOL)
    if vs_interpret:
        je, jl = map(np.asarray, jax_bank(
            np.zeros(batch, np.int32), j_shape, j_sc, interpret=True,
            injected_draws=jax_pack_draws(j_shape, delays, strengths, noise)))
        np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=IR_TOL)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=IR_TOL)


def test_injected_degenerate_smoothing_takes_raw_noise(rng):
    """The degenerate entry keeps synthesize's raw alternating tail (peak 0.7
    over the whole tail) and is flagged; the other entry keeps its smoothed
    tail.  Keeping the smoothed tail would leave only the two edge samples
    of the tail standing."""
    t_shape, t_sc, _, _ = shapes("room48k")
    delays, strengths, noise = make_draws(rng, t_shape, 2)
    noise[0] = alternating_noise(noise.shape[1])
    packed = [torch.from_numpy(a) for a in bank.pack_draws(t_shape, delays, strengths, noise)]
    _, late, raw = bank._rir_bank_plain(*packed, t_sc.table(2, "cpu"), t_shape)
    assert raw.tolist() == [True, False]
    stats = bank._injected_bank_raw(*packed, t_sc.table(2, "cpu"), t_shape)[2]
    # slot 7, max|raw tail| per tile, sets the degenerate entry's peak
    assert float(stats[0, :, 7].max()) > 5 * float(stats[0, :, 5].max())
    tail = late[0, t_shape.split_point:]
    assert float(tail.abs().max()) == pytest.approx(0.7, abs=1e-6)
    head = tail[:2000]  # the decay underflows float32 further out
    assert bool((head != 0).all())
    assert bool((torch.sign(head[:-1]) != torch.sign(head[1:])).all())  # still alternating


def test_injected_bank_structure_and_norms(rng):
    t_shape, t_sc, _, _ = shapes("cathedral16k")
    draws = bank.pack_draws(t_shape, *make_draws(rng, t_shape, 3))
    e, l = bank.fused_rir_bank(torch.zeros(3, dtype=torch.int32), t_shape, t_sc,
                               injected_draws=draws)
    np.testing.assert_allclose(e.abs().amax(1).numpy(), 0.9, atol=1e-4)
    np.testing.assert_allclose(l.abs().amax(1).numpy(), 0.7, atol=1e-4)
    assert not e[:, t_shape.split_point:].any() and not e[:, 0].any()
    assert not l[:, : t_shape.split_point].any()
    head = l[:, t_shape.split_point: t_shape.split_point + 100].abs().amax(1)
    assert bool((l[:, -1600:].abs().amax(1) < 0.1 * head).all())  # the tail decays


def test_injected_plain_stats_match_hash_plain_on_hash_draws():
    """Fed the hash stream's own draws, the injected plain bank reproduces the
    hash plain bank's raw IRs and stats (slots 0-6; slot 7 is the injected
    source's own) and final IRs exactly (one shared body), and flags no
    entry."""
    t_shape, t_sc, _, _ = shapes("room16k")
    seeds = [3, 2**31]
    draws = [tir.hash_draws(s, t_shape) for s in seeds]
    packed = [torch.stack([d[i] for d in draws]) for i in range(3)]
    scal = t_sc.table(2, "cpu")
    seeds_t = torch.from_numpy(tir.seeds_to_int32(seeds))
    early, late, stats, _ = bank._injected_bank_raw(*packed, scal, t_shape)
    want = bank._hash_bank_raw(seeds_t, scal, t_shape)
    assert torch.equal(early, want[0]) and torch.equal(late, want[1])
    assert torch.equal(stats[..., :7], want[2][..., :7])
    *got, raw = bank._rir_bank_plain(*packed, scal, t_shape)
    assert not raw.any()
    for g, w in zip(got, bank._rir_block_plain(seeds_t, scal, t_shape)):
        assert torch.equal(g, w)


class TestPackDraws:
    def test_layout_pads_and_truncates(self, rng):
        t_shape, _, _, _ = shapes("room16k")
        d = rng.integers(1, 50, size=(2, 35)).astype(np.int64)
        s = rng.uniform(0.3, 0.8, size=(2, 35))
        n = rng.uniform(-1, 1, size=(2, t_shape.late_length + 17))
        pd, ps, pn = bank.pack_draws(t_shape, d, s, n)
        assert pd.dtype == np.int32 and pd.shape == (2, tir.MAX_REFLECTIONS)
        assert ps.dtype == np.float32 and pn.shape == (2, t_shape.late_length)
        np.testing.assert_array_equal(pd[:, :35], d)
        assert not pd[:, 35:].any() and not ps[:, 35:].any()
        np.testing.assert_array_equal(pn, n[:, : t_shape.late_length].astype(np.float32))
        short = bank.pack_draws(t_shape, d, s, n[:, :100])[2]
        assert not short[:, 100:].any()

    def test_over_budget_rejected(self):
        t_shape, _, _, _ = shapes("room16k")
        with pytest.raises(ValueError, match="MAX_REFLECTIONS"):
            bank.pack_draws(t_shape, np.ones((1, 81), np.int32), np.ones((1, 81)),
                            np.zeros((1, 10)))

    def test_bank_draws_from_irdraws(self, rng):
        """models.convert.bank_draws: a list of IRDraws → the injected bank's
        inputs, identical to pack_draws."""
        from audio_raytracing_studio_tpu_torch.models import convert

        g = GEOMETRIES["room16k"](tparams)
        t_shape = tir.IRShape.from_geometry(g)
        draws = [tparams.IRDraws.sample(np.random.default_rng(s), g) for s in (1, 2)]
        got = convert.bank_draws(draws, t_shape)
        want = bank.pack_draws(t_shape, np.stack([d.delays for d in draws]),
                               np.stack([d.strengths for d in draws]),
                               np.stack([d.noise for d in draws]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)

    def test_ragged_rows(self, rng):
        """Rows of differing tap counts and noise lengths pad per row."""
        t_shape, _, _, _ = shapes("room16k")
        cols = t_shape.late_length
        d = [rng.integers(1, 50, size=r) for r in (3, 80)]
        s = [rng.uniform(0.3, 0.8, size=r) for r in (3, 80)]
        n = [rng.uniform(-1, 1, size=k) for k in (100, cols + 5)]
        pd, ps, pn = bank.pack_draws(t_shape, d, s, n)
        assert pd.shape == ps.shape == (2, tir.MAX_REFLECTIONS) and pn.shape == (2, cols)
        np.testing.assert_array_equal(pd[0, :3], d[0])
        assert not pd[0, 3:].any() and not ps[0, 3:].any()
        np.testing.assert_array_equal(ps[1], s[1].astype(np.float32))
        np.testing.assert_array_equal(pn[0, :100], n[0].astype(np.float32))
        assert not pn[0, 100:].any()
        np.testing.assert_array_equal(pn[1], n[1][:cols].astype(np.float32))
        with pytest.raises(ValueError, match="MAX_REFLECTIONS"):
            bank.pack_draws(t_shape, [d[0], np.ones(81)], [s[0], np.ones(81)], n)


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
    """Raw stats keep the kernels' meaning: valid counts sum to late_length,
    tiles past the tail are empty, the hash source has no raw-tail slot."""
    t_shape, t_sc, _, _ = shapes("room16k")
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    _, _, stats = bank._hash_bank_raw(seeds, t_sc.table(2, "cpu"), t_shape)
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

    def test_injected_non_cpu_tensor_never_takes_plain_path(self, monkeypatch, rng):
        t_shape, t_sc, _, _ = shapes("room16k")

        def forbidden(*args, **kwargs):
            raise AssertionError("plain path taken for a non-CPU tensor")

        monkeypatch.setattr(bank, "_rir_bank_plain", forbidden)
        draws = bank.pack_draws(t_shape, *make_draws(rng, t_shape, 2))
        with pytest.raises(ValueError, match="cuda or cpu"):
            bank.fused_rir_bank(torch.zeros(2, dtype=torch.int32, device="meta"), t_shape,
                                t_sc, injected_draws=draws)

    def test_injected_kernel_wrapper_rejects_cpu_tensors(self, rng):
        t_shape, t_sc, _, _ = shapes("room16k")
        packed = [torch.from_numpy(a) for a in bank.pack_draws(t_shape, *make_draws(rng, t_shape, 2))]
        before = bank.injected_launch_count
        with pytest.raises(ValueError, match="CUDA device"):
            bank._rir_bank_cuda(*packed, t_sc.table(2, "cpu"), t_shape)
        assert bank.injected_launch_count == before

    def test_render_draws_on_cpu_uses_plain_synthesize(self, monkeypatch, tone48k):
        """On the CPU, render(draws=...) keeps the plain synthesize, as the JAX
        package does; the injected bank is the GPU's producer."""
        from audio_raytracing_studio_tpu_torch.models import pipeline

        def forbidden(*args, **kwargs):
            raise AssertionError("the bank ran for render(draws=...) on the CPU")

        monkeypatch.setattr(pipeline, "fused_rir_bank", forbidden)
        x, rate = tone48k
        p = tparams.RenderParams(target_layout="Stereo")
        d = tparams.IRDraws.sample(np.random.default_rng(1), geometry(p, rate))
        assert pipeline.render(x[:4800], rate, p, draws=d, device="cpu").shape[1] == 2

    def test_cuda_request_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the CUDA-less case")
        from audio_raytracing_studio_tpu_torch.models import pipeline
        from audio_raytracing_studio_tpu_torch.parallel import sharding

        x = np.zeros(800, np.float32)
        p = tparams.RenderParams(target_layout="Stereo")
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
