"""The port's copy of PresetStore (utils/presets.py) against the JAX
package's: a preset saved by either package is byte-identical to the other's
file and loads equal in both; names, the last-used pointer, listing,
deletion and the traversal guard behave alike."""

import dataclasses

import pytest

from audio_raytracing_studio_tpu import params as jparams
from audio_raytracing_studio_tpu.utils.presets import PresetStore as JStore
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore as TStore

PARAMS = {
    "defaults": RenderParams(),
    "cathedral": RenderParams(hall_type="Cathedral", material="Stein", room_size=600.0,
                              diffusion=0.8, air_absorption=0.5, target_layout="7.1 (Surround)"),
    "external": RenderParams(use_external_ir=True, dry_wet=0.7, dry_wet_kill_start=0.4,
                             bass_gain=1.6, treble_gain=0.6, x_pos=0.2, y_pos=0.9, z_pos=0.1),
}
NAMES = ["Hall", "My Preset", "  spaced  name ", "Ünïcode Hall", "a/b:c*d", "x-y_z"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("which", list(PARAMS))
def test_saved_files_byte_identical_and_cross_load(tmp_path, which, name):
    p = PARAMS[which]
    msg_t, file_t = TStore(str(tmp_path / "t")).save(name, p)
    msg_j, file_j = JStore(str(tmp_path / "j")).save(
        name, jparams.RenderParams(**dataclasses.asdict(p)))
    assert (msg_t, file_t) == (msg_j, file_j)
    blob_t = (tmp_path / "t" / "presets_v4" / file_t).read_bytes()
    assert blob_t == (tmp_path / "j" / "presets_v4" / file_j).read_bytes()
    # each package loads the other's file to the same parameters
    got_t = TStore(str(tmp_path / "j")).load(file_j)
    got_j = JStore(str(tmp_path / "t")).load(file_t)
    assert isinstance(got_t, RenderParams) and got_t == p
    assert dataclasses.asdict(got_j) == dataclasses.asdict(p)
    assert TStore(str(tmp_path / "t")).load_last() == JStore(str(tmp_path / "j")).load_last()


@pytest.mark.parametrize("name", ["", "   ", "***", "/", "x" * 300])
def test_invalid_names_rejected_like_jax(tmp_path, name):
    assert TStore.sanitize_name(name) == JStore.sanitize_name(name) is None
    with pytest.raises(ValueError):
        TStore(str(tmp_path)).save(name, RenderParams())


@pytest.mark.parametrize("preset_file", ["../README.md", "a/b.json", "..", "x.txt", ""])
def test_traversal_names_refused(tmp_path, preset_file):
    store = TStore(str(tmp_path))
    with pytest.raises(ValueError, match="invalid preset filename"):
        store.load(preset_file)
    assert store.delete(preset_file) is False


def test_list_delete_and_last_pointer(tmp_path):
    t, j = TStore(str(tmp_path / "t")), JStore(str(tmp_path / "j"))
    for store in (t, j):
        for name in ("b hall", "A Room", "c"):
            store.save(name, RenderParams() if store is t else jparams.RenderParams())
    assert t.list_presets() == j.list_presets() == ["A_Room_v4.json", "b_hall_v4.json",
                                                    "c_v4.json"]
    assert t.load_last() == j.load_last() == "c_v4.json"
    assert t.delete("c_v4.json") and j.delete("c_v4.json")
    assert t.load_last() is None and j.load_last() is None
    assert t.list_presets() == j.list_presets()
    # partial preset files coerce with per-key defaults in both packages
    path = tmp_path / "t" / "presets_v4" / "partial_v4.json"
    path.write_text('{"hall_type": "Plate", "room_size": "12.5", "use_external_ir": 1}')
    got = t.load("partial_v4.json")
    want = JStore(str(tmp_path / "t")).load("partial_v4.json")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    zipped = t.export_zip(str(tmp_path / "all.zip"))
    assert zipped is not None and (tmp_path / "all.zip").stat().st_size > 0
