"""The port's reference-API façade (compat.py) against the JAX package's.

Every name of ``__all__`` is present with the JAX signature, apart from
``backend``'s default (``"torch"`` for ``"jax"``) and the ``device`` keyword
beside it.  Tolerances: each DSP function's device arm (``device="cpu"``)
within ``DSP_TOL`` = 2e-5 max-abs of the JAX one (float32 round-off in
another order; the bound the JAX backends meet among themselves) and within
the parity contract's 1e-3 of its float64 ``"oracle"`` arm; each ``"oracle"``
arm **equal** to the JAX package's; metrics within 0.01 LU / dB; host-side
helpers, constants and UI handlers equal.  Gaps are recorded with
``record_property``.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu import compat as jrs
from audio_raytracing_studio_tpu_torch import compat as trs
from audio_raytracing_studio_tpu_torch.utils import runtime

torch.set_num_threads(1)

DSP_TOL = 2e-5
ORACLE_TOL = 1e-3
RATE = 16000
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def temp_files_in_tmp_path(tmp_path, monkeypatch):
    """Every handler leaves its result in a ``NamedTemporaryFile(delete=False)``:
    point ``tempfile`` at the test's own directory, which pytest removes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def signal(n, channels, seed, gain=0.3):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.017 * t)[:, None] + 0.4 * r.standard_normal((n, channels))
    return (gain * x).astype(np.float32)


CLIP = signal(int(0.3 * RATE), 2, 1)
HOT = signal(int(0.3 * RATE), 2, 2, gain=0.9)  # clips after panning: normalization engages


def irs(mod, seed=11, **kw):
    dur, refs, maxd, split = mod.adjust_parameters_for_3d("Room", 120.0, 0.4)
    direc = mod.compute_final_directionality_3d(0.3, 0.6, 0.4, "Room", 0.5, 0.5)
    return mod.generate_impulse_response_split_3d(
        RATE, dur, refs, maxd, "Beton", direc, split, 0.5, seed=seed, **kw)


def close(record_property, got, want, tol=DSP_TOL, name="max_abs"):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    gap = float(np.abs(got - want).max()) if got.size else 0.0
    record_property(name, gap)
    assert gap <= tol, gap


# --- the surface ---------------------------------------------------------------


def test_all_lists_the_same_names():
    assert trs.__all__ == jrs.__all__
    assert len(set(trs.__all__)) == len(trs.__all__) == 40


@pytest.mark.parametrize("name", [n for n in jrs.__all__ if callable(getattr(jrs, n))])
def test_signature_equals_the_jax_one(name):
    """Same parameters in the same order with the same defaults; the port's
    only differences are ``backend="torch"`` and the ``device=None`` keyword."""
    t_sig, j_sig = (inspect.signature(getattr(m, name)) for m in (trs, jrs))
    t_params = [p for p in t_sig.parameters.values() if p.name != "device"]
    assert [p.name for p in t_params] == list(j_sig.parameters)
    for p, q in zip(t_params, j_sig.parameters.values()):
        assert p.kind == q.kind, p.name
        if p.name == "backend":
            assert (p.default, q.default) == ("torch", "jax")
        else:
            assert p.default == q.default, p.name
    if "backend" in j_sig.parameters:
        device = t_sig.parameters["device"]
        assert device.default is None and device.kind is inspect.Parameter.KEYWORD_ONLY
    else:
        assert "device" not in t_sig.parameters


@pytest.mark.parametrize("name", [n for n in jrs.__all__ if not callable(getattr(jrs, n))])
def test_constants_equal(name):
    assert getattr(trs, name) == getattr(jrs, name)


def test_orchestrator_reexports_are_the_ports_entry_points():
    from audio_raytracing_studio_tpu_torch.app import api

    assert trs.apply_raytrace_convolution_3d is api.apply_raytrace_convolution_3d
    assert trs.process_audio_main_v41 is api.process_audio_main_v41


# --- parameter math -------------------------------------------------------------


@pytest.mark.parametrize("hall", ["Room", "Plate", "Cathedral", "Unknown Hall"])
def test_parameter_math_equal(hall):
    assert trs.adjust_reverb_parameters_by_hall(hall) == jrs.adjust_reverb_parameters_by_hall(hall)
    for size, z in ((10.0, 0.0), (300.0, 0.5), (-5.0, 1.0)):
        assert trs.adjust_parameters_for_3d(hall, size, z) == \
            jrs.adjust_parameters_for_3d(hall, size, z)
    assert trs.compute_final_directionality_3d(0.2, 0.7, 0.9, hall, 0.3, 0.6) == \
        jrs.compute_final_directionality_3d(0.2, 0.7, 0.9, hall, 0.3, 0.6)
    assert trs.adapt_early_late_levels(0.7, 0.8, 0.6) == jrs.adapt_early_late_levels(0.7, 0.8, 0.6)
    assert trs.update_hall_info(hall) == jrs.update_hall_info(hall)


# --- DSP ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11, 2**32 - 1])
def test_impulse_response_matches_jax_and_its_oracle_arm(record_property, seed):
    early, late = irs(trs, seed, **CPU)
    early_j, late_j = irs(jrs, seed)
    close(record_property, early, early_j, name="early_vs_jax")
    close(record_property, late, late_j, name="late_vs_jax")
    early_o, late_o = irs(trs, seed, backend="oracle")
    early_jo, late_jo = irs(jrs, seed, backend="oracle")
    assert np.array_equal(early_o, early_jo) and np.array_equal(late_o, late_jo)
    close(record_property, early, early_o, ORACLE_TOL, "early_vs_oracle")
    close(record_property, late, late_o, ORACLE_TOL, "late_vs_oracle")
    again = irs(trs, seed, **CPU)
    assert np.array_equal(again[0], early) and np.array_equal(again[1], late)
    assert not np.array_equal(irs(trs, seed ^ 1, **CPU)[1], late)


def test_impulse_response_caps_reflections_at_80(record_property):
    args = (RATE, 0.4, 500, 0.05, "Beton", 0.5, 0.08, 0.5)
    early, late = trs.generate_impulse_response_split_3d(*args, seed=3, **CPU)
    early_j, late_j = jrs.generate_impulse_response_split_3d(*args, seed=3)
    close(record_property, early, early_j)
    early_o, _ = trs.generate_impulse_response_split_3d(*args, seed=3, backend="oracle")
    close(record_property, early, early_o, ORACLE_TOL, "vs_oracle")


@pytest.mark.parametrize("rate, duration", [(0, 1.0), (RATE, 0.0), (RATE, -1.0)])
def test_degenerate_impulse_response_equal(rate, duration):
    for kw in (CPU, dict(backend="oracle")):
        got = trs.generate_impulse_response_split_3d(rate, duration, 10, 0.05, "Beton", 0.5,
                                                     0.08, 0.5, **kw)
        want = jrs.generate_impulse_response_split_3d(rate, duration, 10, 0.05, "Beton", 0.5,
                                                      0.08, 0.5)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("bass, treble, air, dry_wet", [
    (1.0, 1.0, 0.0, 0.5), (1.6, 0.7, 0.3, 0.5), (1.0, 1.0, 0.3, 0.9), (1.3, 1.0, 0.005, 0.0),
], ids=["plain", "eq-air", "air-dry-kill", "eq-dry-only"])
def test_convolve_split_matches_jax_and_oracle(record_property, bass, treble, air, dry_wet):
    early, late = irs(jrs)
    args = (CLIP, early, late, 0.8, 0.6, dry_wet, bass, treble, RATE, 0.5, air)
    got = trs.convolve_audio_split_3d(*args, **CPU)
    close(record_property, got, jrs.convolve_audio_split_3d(*args), name="vs_jax")
    oracle = trs.convolve_audio_split_3d(*args, backend="oracle")
    assert np.array_equal(oracle, jrs.convolve_audio_split_3d(*args, backend="oracle"))
    close(record_property, got, oracle, ORACLE_TOL, "vs_oracle")
    assert got.shape == (CLIP.shape[0] + early.shape[0] - 1, 2)


@pytest.mark.parametrize("case", ["unequal-lengths", "early-silent", "late-level-zero", "mono",
                                  "six-channels"])
def test_convolve_split_edge_inputs(record_property, case):
    early, late = irs(jrs)
    data, lvl_e, lvl_l = CLIP, 0.8, 0.6
    if case == "unequal-lengths":
        late = late[: late.shape[0] // 2]
    elif case == "early-silent":
        early = np.zeros_like(early)
    elif case == "late-level-zero":
        lvl_l = 0.0
    elif case == "mono":
        data = CLIP[:, 0]
    elif case == "six-channels":
        data = signal(CLIP.shape[0], 6, 4)
    args = (data, early, late, lvl_e, lvl_l, 0.6, 1.2, 0.9, RATE, 0.5, 0.2)
    close(record_property, trs.convolve_audio_split_3d(*args, **CPU),
          jrs.convolve_audio_split_3d(*args))


@pytest.mark.parametrize("data", [None, np.zeros((0, 2), np.float32)], ids=["none", "empty"])
def test_convolve_empty_input_equal(data):
    early, late = irs(jrs)
    for got, want in (
        (trs.convolve_audio_split_3d(data, early, late, 0.8, 0.6, 0.5, **CPU),
         jrs.convolve_audio_split_3d(data, early, late, 0.8, 0.6, 0.5)),
        (trs.convolve_audio_external_ir(data, signal(100, 2, 5), 0.5, **CPU),
         jrs.convolve_audio_external_ir(data, signal(100, 2, 5), 0.5)),
        (trs.apply_surround_panning_3d(data, 0.5, 0.5, 0.5, **CPU),
         jrs.apply_surround_panning_3d(data, 0.5, 0.5, 0.5)),
    ):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("bass, treble, dry_wet", [(1.0, 1.0, 0.5), (1.6, 0.7, 0.8)])
def test_convolve_external_matches_jax_and_oracle(record_property, bass, treble, dry_wet):
    ir = signal(700, 2, 6) * np.exp(-np.arange(700) / 150.0)[:, None].astype(np.float32)
    args = (CLIP, ir, dry_wet, bass, treble, RATE, 0.5)
    got = trs.convolve_audio_external_ir(*args, **CPU)
    close(record_property, got, jrs.convolve_audio_external_ir(*args), name="vs_jax")
    oracle = trs.convolve_audio_external_ir(*args, backend="oracle")
    assert np.array_equal(oracle, jrs.convolve_audio_external_ir(*args, backend="oracle"))
    close(record_property, got, oracle, ORACLE_TOL, "vs_oracle")


@pytest.mark.parametrize("ir", [None, signal(100, 1, 7), signal(100, 2, 7)[:, 0], [[0.1, 0.2]]],
                         ids=["none", "mono-2d", "mono-1d", "list"])
def test_convolve_external_rejects_a_non_stereo_ir_like_jax(ir):
    got = trs.convolve_audio_external_ir(CLIP, ir, 0.5, **CPU)
    assert np.array_equal(got, jrs.convolve_audio_external_ir(CLIP, ir, 0.5))
    assert np.array_equal(got, CLIP)


@pytest.mark.parametrize("pos", [(0.5, 0.5, 0.5), (0.1, 0.9, 0.2), (1.0, 0.0, 1.0),
                                 (-2.0, 3.0, 0.5)])
@pytest.mark.parametrize("data", [CLIP, HOT], ids=["quiet", "hot"])
def test_panning_matches_jax_and_oracle(record_property, pos, data):
    got = trs.apply_surround_panning_3d(data, *pos, **CPU)
    close(record_property, got, jrs.apply_surround_panning_3d(data, *pos), name="vs_jax")
    oracle = trs.apply_surround_panning_3d(data, *pos, backend="oracle")
    assert np.array_equal(oracle, jrs.apply_surround_panning_3d(data, *pos, backend="oracle"))
    close(record_property, got, oracle, ORACLE_TOL, "vs_oracle")
    assert got.shape == (data.shape[0], 6)


@pytest.mark.parametrize("layout", ["Stereo", "5.1 (Standard)", "7.1 (Surround)",
                                    "5.1.2 (Atmos Light)", "no such layout"])
def test_map_channels_matches_jax_and_oracle(record_property, layout):
    six = jrs.apply_surround_panning_3d(HOT, 0.3, 0.6, 0.8)
    got, names = trs.map_channels(six, layout, RATE, 0.8, **CPU)
    want, names_j = jrs.map_channels(six, layout, RATE, 0.8)
    assert names == names_j
    close(record_property, got, want, name="vs_jax")
    oracle, names_o = trs.map_channels(six, layout, RATE, 0.8, backend="oracle")
    oracle_j, _ = jrs.map_channels(six, layout, RATE, 0.8, backend="oracle")
    assert names_o == names and np.array_equal(oracle, oracle_j)
    close(record_property, got, oracle, ORACLE_TOL, "vs_oracle")


@pytest.mark.parametrize("data", [None, np.zeros((10, 2), np.float32), np.zeros(10, np.float32)],
                         ids=["none", "stereo", "1-d"])
def test_map_channels_wrong_shape_equal(data):
    got, names = trs.map_channels(data, "7.1 (Surround)", RATE, **CPU)
    want, names_j = jrs.map_channels(data, "7.1 (Surround)", RATE)
    assert names == names_j and got.shape == want.shape == (0, 8)


@pytest.mark.parametrize("factor", [0.0, 0.005, 0.3, 1.0, 4.0])
def test_lp_filter_matches_jax_and_oracle(record_property, factor):
    x = signal(4001, 2, 8)
    got = trs.apply_simple_lp_filter(x, RATE, factor, **CPU)
    close(record_property, got, jrs.apply_simple_lp_filter(x, RATE, factor), name="vs_jax")
    oracle = trs.apply_simple_lp_filter(x, RATE, factor, backend="oracle")
    assert np.array_equal(oracle, jrs.apply_simple_lp_filter(x, RATE, factor, backend="oracle"))
    close(record_property, got, oracle, ORACLE_TOL, "vs_oracle")
    if factor < 0.01:
        assert got is x  # the reference's skip returns the input itself


@pytest.mark.parametrize("x", [None, [1.0, 2.0], np.zeros(8, np.float32),
                               np.zeros((0, 2), np.float32), np.zeros((1, 2), np.float32)],
                         ids=["none", "list", "1-d", "empty", "one-sample"])
def test_lp_filter_guards_return_the_input(x):
    assert trs.apply_simple_lp_filter(x, RATE, 0.5, **CPU) is x
    assert jrs.apply_simple_lp_filter(x, RATE, 0.5) is x


@pytest.mark.parametrize("dry_wet, kill", [(0.0, 0.5), (0.5, 0.5), (0.8, 0.5), (1.0, 0.2)])
def test_host_side_mix_and_delay_equal(dry_wet, kill):
    wet = signal(CLIP.shape[0] + 900, 2, 9)
    assert np.array_equal(trs.dynamic_dry_wet_mix(CLIP, wet, dry_wet, kill),
                          jrs.dynamic_dry_wet_mix(CLIP, wet, dry_wet, kill))
    for delay in (0, 37, 10**6):
        assert np.array_equal(trs.apply_delay(CLIP, delay), jrs.apply_delay(CLIP, delay))
    assert trs.apply_delay("not an array", 3) == "not an array"


@pytest.mark.parametrize("data, rate", [(signal(RATE, 2, 10), RATE), (signal(48000, 6, 11), 48000),
                                        (signal(RATE, 1, 12)[:, 0], RATE)],
                         ids=["stereo", "six", "1-d"])
def test_metrics_match_jax_and_oracle(record_property, data, rate):
    got, want = trs.calculate_audio_metrics(data, rate, **CPU), \
        jrs.calculate_audio_metrics(data, rate)
    gap = max(abs(got[k] - want[k]) for k in want)
    record_property("metrics_gap", gap)
    assert set(got) == set(want) and gap <= 0.01
    assert trs.calculate_audio_metrics(data, rate, backend="oracle") == \
        jrs.calculate_audio_metrics(data, rate, backend="oracle")


@pytest.mark.parametrize("data, rate", [(None, RATE), ([0.1, 0.2], RATE),
                                        (np.zeros((0, 2), np.float32), RATE), (CLIP, 0),
                                        (np.zeros((4, 2, 2), np.float32), RATE)],
                         ids=["none", "list", "empty", "rate-0", "3-d"])
def test_metrics_invalid_input_gives_none_like_jax(data, rate):
    got = trs.calculate_audio_metrics(data, rate, **CPU)
    assert got == jrs.calculate_audio_metrics(data, rate)
    assert got == {"lufs": None, "true_peak_dbfs": None, "rms_dbfs": None}


def test_silence_metrics_equal():
    x = np.zeros((RATE, 2), np.float32)
    assert trs.calculate_audio_metrics(x, RATE, **CPU) == jrs.calculate_audio_metrics(x, RATE)


@pytest.mark.parametrize("layout", ["Stereo", "5.1.2 (Atmos Light)"])
def test_facade_composes_to_the_ports_render(record_property, layout):
    """The reference orchestrator's call order, piece by piece through the
    façade, gives ``models.pipeline.render`` of the same settings and seed
    (≤ DSP_TOL: the render draws its IRs from the bank, the façade from
    ``synthesize``), and the JAX façade's chain within the same bound."""
    from audio_raytracing_studio_tpu_torch import params as P
    from audio_raytracing_studio_tpu_torch.models import pipeline

    audio = signal(3000, 2, 13, gain=0.15)
    rate = 8000
    p = P.RenderParams(hall_type="Plate", room_size=220.0, diffusion=0.4, air_absorption=0.3,
                       early_level=0.9, late_level=0.7, dry_wet=0.55, dry_wet_kill_start=0.4,
                       bass_gain=1.3, treble_gain=0.8, x_pos=0.3, y_pos=0.65, z_pos=0.45,
                       target_layout=layout)

    def chain(rs, **kw):
        dur, refs, maxd, split = rs.adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
        direc = rs.compute_final_directionality_3d(p.x_pos, p.y_pos, p.z_pos, p.hall_type,
                                                   p.diffusion, p.dry_wet)
        e, l = rs.generate_impulse_response_split_3d(rate, dur, refs, maxd, p.material, direc,
                                                     split, p.diffusion, seed=11, **kw)
        el, ll = rs.adapt_early_late_levels(p.dry_wet, p.early_level, p.late_level)
        mixed = rs.convolve_audio_split_3d(audio, e, l, el, ll, p.dry_wet, p.bass_gain,
                                           p.treble_gain, rate, p.dry_wet_kill_start,
                                           p.air_absorption, **kw)
        six = rs.apply_surround_panning_3d(mixed, p.x_pos, p.y_pos, p.z_pos, **kw)
        return rs.map_channels(six, p.target_layout, rate, p.z_pos, **kw)[0]

    mapped = chain(trs, **CPU)
    close(record_property, mapped, pipeline.render(audio, rate, p, seed=11, device="cpu"),
          name="vs_render")
    close(record_property, mapped, chain(jrs), name="vs_jax_chain")


# --- the device keyword ----------------------------------------------------------


def test_device_none_is_the_process_wide_default():
    previous = runtime.set_default_device("cpu")
    try:
        a = trs.apply_surround_panning_3d(CLIP, 0.3, 0.6, 0.5)
        assert np.array_equal(a, trs.apply_surround_panning_3d(CLIP, 0.3, 0.6, 0.5, **CPU))
        assert trs.calculate_audio_metrics(CLIP, RATE) == \
            trs.calculate_audio_metrics(CLIP, RATE, **CPU)
    finally:
        runtime.set_default_device(previous)


@pytest.mark.parametrize("call", [
    lambda kw: irs(trs, **kw),
    lambda kw: trs.apply_simple_lp_filter(CLIP, RATE, 0.4, **kw),
    lambda kw: trs.convolve_audio_split_3d(CLIP, *irs(jrs), 0.8, 0.6, 0.5, **kw),
    lambda kw: trs.convolve_audio_external_ir(CLIP, signal(200, 2, 14), 0.5, **kw),
    lambda kw: trs.apply_surround_panning_3d(CLIP, 0.5, 0.5, 0.5, **kw),
    lambda kw: trs.map_channels(signal(100, 6, 15), "Stereo", RATE, **kw),
    lambda kw: trs.calculate_audio_metrics(CLIP, RATE, **kw),
], ids=["ir", "lp", "split", "external", "pan", "map", "metrics"])
def test_cuda_without_a_card_raises_and_the_oracle_arm_needs_no_device(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    previous = runtime.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            call({})
        with pytest.raises(RuntimeError, match="CUDA"):
            call(dict(device="cuda"))
        call(dict(backend="oracle"))
    finally:
        runtime.set_default_device(previous)


# --- presets and UI handlers -------------------------------------------------------


@pytest.fixture
def twin_dirs(tmp_path, monkeypatch):
    """Run an action in the port's directory, then in the JAX package's."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()

    def each(action):
        out = []
        for rs, sub in ((trs, "t"), (jrs, "j")):
            monkeypatch.chdir(tmp_path / sub)
            out.append(action(rs))
        return out
    return each


def test_preset_cycle_through_the_reference_names(twin_dirs, tmp_path):
    values = [False, "Cathedral", "Beton", 600.0, 0.4, 0.2, 0.9, 0.5, 0.6, 0.4, 1.2, 0.9,
              0.3, 0.7, 0.5, "7.1 (Surround)"]

    def cycle(rs):
        rs.ensure_preset_dir()
        assert rs.list_presets_for_dropdown_v4() == [] and rs.load_last_preset() is None
        saved = rs.save_current_preset_v4("Mein Saal", *values)
        listing = rs.list_presets_for_dropdown_v4()
        loaded = rs.load_selected_preset_v4("Mein_Saal_v4.json")
        last = rs.load_last_preset()
        rs.save_last_preset("other_v4.json")
        last2 = rs.load_last_preset()
        zip_path = rs.export_presets_as_zip_v4()
        zipped = os.path.getsize(zip_path) > 0
        os.remove(zip_path)
        deleted = rs.delete_selected_preset_v4("Mein_Saal_v4.json")
        return saved, listing, loaded, last, last2, zipped, deleted, \
            rs.list_presets_for_dropdown_v4(), rs.delete_selected_preset_v4(None), \
            rs.save_current_preset_v4("???", *values)

    got, want = twin_dirs(cycle)
    assert got == want
    assert got[1] == ["Mein_Saal_v4.json"] and [u["value"] for u in got[2]] == values


def test_ui_handlers_equal(twin_dirs):
    from PIL import Image

    def handlers(rs):
        start = rs.on_start_v41()
        marker_path = rs.update_marker_image(0.25, 0.75)
        with Image.open(marker_path) as img:
            marker_px = np.asarray(img.convert("RGBA"))
        os.remove(marker_path)
        click = rs.update_controls_from_click(type("Evt", (), {"index": (150, 300)})())
        bad = rs.update_controls_from_click(None)
        slider = rs.handle_slider_change(0.1, 0.9)
        for update in (start[18], click[2], slider):
            os.remove(update["value"])
        strip = lambda ups: [{k: v for k, v in u.items()  # noqa: E731 — temp names differ
                              if not (k == "value" and isinstance(v, str) and v.endswith(".png")
                                      and os.path.isabs(v))} for u in ups]
        return (strip(start), marker_px.tolist(), strip(click), bad, strip([slider]),
                rs.toggle_ir_controls_v4(True), rs.toggle_ir_controls_v4(0))

    got, want = twin_dirs(handlers)
    assert got == want
    assert len(got[0]) == 29 and got[2][0]["value"] == pytest.approx(0.25)


def test_plot_and_profiler_names(tmp_path):
    from PIL import Image

    from audio_raytracing_studio_tpu_torch.utils import wavio

    path = str(tmp_path / "clip.wav")
    wavio.write(path, CLIP, RATE)
    got, want = trs.plot_waveform_and_spectrogram_v4(path, "Titel"), \
        jrs.plot_waveform_and_spectrogram_v4(path, "Titel")
    try:
        with Image.open(got) as a, Image.open(want) as b:
            assert np.array_equal(np.asarray(a), np.asarray(b))
    finally:
        os.remove(got)
        os.remove(want)
    previous = runtime.set_default_device("cpu")
    try:
        assert trs.run_audio_profiler_v4(path, path) == jrs.run_audio_profiler_v4(path, path)
    finally:
        runtime.set_default_device(previous)
