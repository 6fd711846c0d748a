"""The render graph's back half (``ops/back_half_cuda.py``) on the CPU: the
plain version that CPU tensors take, clip by clip against the JAX package's
``_mix_eq_spatial`` (≤ 1e-5, the filters-and-spatial tolerance of
``test_torch_pipeline.py``), and bit for bit against the port's own
``_mix_eq_spatial``, which routes to it; the kernels' per-clip coefficient
table against ``pan_matrix`` and the config constants; and that a CPU render
never counts a kernel launch.  The CUDA kernels themselves are held to the
plain version on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.models import pipeline as jpipe
from audio_raytracing_studio_tpu_torch import RenderParams, config
from audio_raytracing_studio_tpu_torch.models import pipeline
from audio_raytracing_studio_tpu_torch.ops import back_half_cuda, filters, spatial
from audio_raytracing_studio_tpu_torch.parallel import sharding
from audio_raytracing_studio_tpu_torch.utils import profiling

torch.set_num_threads(1)

LAYOUTS = ("Stereo", "5.1 (Standard)", "7.1 (Surround)", "5.1.2 (Atmos Light)")
RATE = 16000


def scalars(batch: int, seed: int) -> pipeline.MixScalars:
    """Per-clip (B,) float32 mix scalars, positions over the whole square
    (clip 0 at the corner where the front-left gain exceeds 1)."""
    r = np.random.default_rng(seed)
    cols = {f: r.uniform(0.0, 1.0, batch) for f in pipeline.MixScalars._fields}
    for f in ("x_pos", "y_pos", "z_pos"):
        cols[f][0] = 0.0
    cols["bass_gain"] = r.uniform(0.5, 2.0, batch)
    cols["treble_gain"] = r.uniform(0.5, 2.0, batch)
    return pipeline.MixScalars(*(torch.tensor(cols[f], dtype=torch.float32)
                                 for f in pipeline.MixScalars._fields))


def clips(batch: int, n_in: int, n: int, seed: int):
    """(dry (B, 2, n_in), wet (B, 2, n)): clip 0 loud (every normalization
    scales), clip 1 quiet, clip 2 below 1e-9 (zeroed), the rest at unit
    scale."""
    r = np.random.default_rng(seed)
    dry = r.uniform(-1.0, 1.0, (batch, 2, n_in)).astype(np.float32)
    wet = r.uniform(-1.0, 1.0, (batch, 2, n)).astype(np.float32)
    for x in (dry, wet):
        x[0] *= 3.0
        x[1] *= 0.2
        x[2] *= 1e-11
    return torch.from_numpy(dry), torch.from_numpy(wet)


@pytest.mark.parametrize("eq_on", [False, True], ids=["eq-off", "eq-on"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_equals_the_staged_back_half(layout, eq_on):
    """The staged back half is the JAX package's ``_mix_eq_spatial`` (one
    clip at a time): the plain version holds to it within 1e-5."""
    batch, n_in, n = 5, 1500, 1877
    dry, wet = clips(batch, n_in, n, seed=7)
    scal = scalars(batch, seed=8)

    def eq(mixed):
        return filters.apply_shelf_eq(mixed, RATE, scal.bass_gain, scal.treble_gain)

    got = back_half_cuda.back_half_plain(dry, wet, scal, layout, RATE, eq if eq_on else None)
    assert got.shape == (batch, config.CHANNEL_LAYOUTS[layout]["channels"], n)
    assert not got[2].any()  # the sub-1e-9 clip is zeroed
    assert float(got[0].abs().max()) <= 1.0
    spec = pipeline.StaticSpec(n_in=n_in, ir_length=n - n_in + 1, rate=RATE, layout=layout,
                               eq_on=eq_on, air_on=False, early_on=True, late_on=True)
    assert torch.equal(pipeline._mix_eq_spatial(dry, wet, scal, spec), got)
    jspec = jpipe.StaticSpec(*spec)
    padded = torch.nn.functional.pad(dry, (0, n - n_in)).numpy()
    for b in range(batch):
        jscal = jpipe.MixScalars(*(jnp.float32(float(x[b])) for x in scal))
        want = np.asarray(jpipe._mix_eq_spatial(jnp.asarray(padded[b]), jnp.asarray(wet[b]),
                                                jscal, jspec))
        assert float(np.abs(got[b].numpy().astype(np.float64) - want).max()) <= 1e-5, b


@pytest.mark.parametrize("layout", LAYOUTS + ("no such layout",))
def test_coefficient_table(layout):
    batch, rate = 6, 48000
    scal = scalars(batch, seed=11)
    table, code, delay = back_half_cuda.coefficients(scal, layout, rate)
    assert table.shape == (batch, back_half_cuda.N_COEFS) and table.dtype == torch.float32
    assert torch.equal(table[:, 0], scal.dry_factor * (1.0 - scal.dry_wet))
    assert torch.equal(table[:, 1], scal.dry_wet)
    pan = spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos)
    assert torch.equal(table[:, 2:8], pan[:, 0]) and torch.equal(table[:, 8:14], pan[:, 1])
    f32 = lambda v: torch.full((batch,), v, dtype=torch.float32)  # noqa: E731
    name = layout if layout in config.CHANNEL_LAYOUTS else config.DEFAULT_CHANNEL_LAYOUT
    want = {
        "Stereo": (0, 0, f32(config.DOWNMIX_CENTER_GAIN), f32(config.DOWNMIX_REAR_GAIN)),
        "5.1 (Standard)": (1, 0, f32(0.0), f32(0.0)),
        "7.1 (Surround)": (2, int(rate * config.SIDE_DELAY_MS / 1000), f32(config.SIDE_GAIN),
                           f32(0.0)),
        "5.1.2 (Atmos Light)": (2, int(rate * config.HEIGHT_DELAY_MS / 1000),
                                scal.z_pos.clamp(0.0, 1.0) * config.HEIGHT_Z_GAIN, f32(0.0)),
    }[name]
    assert (code, delay) == want[:2] == (back_half_cuda.LAYOUT_CODES[name], want[1])
    assert torch.equal(table[:, 14], want[2]) and torch.equal(table[:, 15], want[3])
    assert delay in (0, 576, 864)  # 48 kHz: 12 ms sides, 18 ms heights


@pytest.mark.parametrize("eq_on", [False, True], ids=["eq-off", "eq-on"])
def test_cpu_render_takes_the_plain_path(eq_on):
    rate = RATE
    t = np.arange(rate // 4) / rate
    audio = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 60 * i) * t)).astype(np.float32)
                      for i in range(2)])
    p = RenderParams(target_layout="Stereo", bass_gain=1.6 if eq_on else 1.0)
    lengths = [rate // 4, rate // 5] if eq_on else None
    before = back_half_cuda.launch_count
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = sharding.render_batch(audio, rate, p, seeds=[1, 2], clip_lengths=lengths,
                                        device="cpu")
        counters = profiling.counters()
        calls = profiling.span_table()["ars.back_half"]["calls"]
    finally:
        profiling.reset_spans()
    assert out.shape[0] == 2 and np.isfinite(out).all()
    assert calls == 1
    assert back_half_cuda.launch_count == before
    assert counters.get("ars.back_half_kernels", 0) == 0


def test_back_half_refuses_other_devices():
    scal = scalars(1, seed=1)
    meta = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        back_half_cuda.back_half(meta, meta, scal, "Stereo", RATE)
