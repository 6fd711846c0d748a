"""The port's position-map helpers (app/marker.py) against the JAX package's:
the rendered map and the marker PNGs have equal pixels (no tolerance — same
PIL calls), ``click_to_normalized`` returns equal values, and the module
imports without importing PIL."""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from audio_raytracing_studio_tpu.app import marker as jmarker
from audio_raytracing_studio_tpu_torch.app import marker as tmarker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def temp_files_in_tmp_path(tmp_path, monkeypatch):
    """Every handler leaves its result in a ``NamedTemporaryFile(delete=False)``:
    point ``tempfile`` at the test's own directory, which pytest removes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def pixels(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"))


@pytest.fixture
def maps(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmarker.render_map_asset(str(tmp_path / "t.png")), \
        jmarker.render_map_asset(str(tmp_path / "j.png"))


def test_map_asset_pixels_equal(maps):
    a, b = pixels(maps[0]), pixels(maps[1])
    assert a.shape == (tmarker.MAP_SIZE[1], tmarker.MAP_SIZE[0], 4)
    assert tmarker.MAP_SIZE == jmarker.MAP_SIZE and np.array_equal(a, b)


@pytest.mark.parametrize("x, y", [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.25, 0.8), (-3.0, 7.0),
                                  ("0.3", "0.6")])
def test_marker_pixels_equal(maps, x, y):
    got, want = tmarker.update_marker_image(x, y, maps[0]), jmarker.update_marker_image(x, y, maps[1])
    try:
        assert np.array_equal(pixels(got), pixels(want))
        assert not np.array_equal(pixels(got), pixels(maps[0]))
    finally:
        os.remove(got)
        os.remove(want)


@pytest.mark.parametrize("x, y", [("left", 0.5), (None, None)])
def test_marker_bad_values_give_none_like_jax(maps, x, y):
    assert tmarker.update_marker_image(x, y, maps[0]) is None
    assert jmarker.update_marker_image(x, y, maps[1]) is None


def test_marker_without_a_base_image(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no map asset in the working directory
    assert tmarker.update_marker_image(0.5, 0.5) is None
    assert jmarker.update_marker_image(0.5, 0.5) is None
    assert tmarker.click_to_normalized(10, 10) is None
    path = tmarker.ensure_map_asset()
    assert os.path.exists(path) and tmarker.ensure_map_asset() == path
    got = tmarker.update_marker_image(0.5, 0.5)  # falls back to the asset
    assert got and os.path.exists(got)
    os.remove(got)


@pytest.mark.parametrize("click", [(0, 0), (300, 100), (599, 399), (900, -4), (450.5, 20.25)])
def test_click_to_normalized_equal(maps, click):
    assert tmarker.click_to_normalized(*click, maps[0]) == jmarker.click_to_normalized(*click, maps[1])


def test_module_imports_without_pil():
    code = ("import sys\n"
            "import audio_raytracing_studio_tpu_torch.app.marker as m\n"
            "assert m.pil_available()\n"
            "sys.exit(1 if any(k == 'PIL' or k.startswith('PIL.') for k in sys.modules) else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ensure_map_asset_without_pil_leaves_the_map_missing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmarker, "pil_available", lambda: False)
    path = tmarker.ensure_map_asset()
    assert not os.path.exists(path)
    assert tmarker.update_marker_image(0.5, 0.5) is None
