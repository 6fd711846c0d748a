"""The port's codec bench (tools/bench_codecs.py) on the CPU at a tiny
length: one JSON line per (codec, length) with the JAX tool's numbers, the
tier that decoded it, ``"host_only": true`` and the device; a codec whose
library is absent prints ``"available": false`` and no numbers; the PCM16
line's native and NumPy conversions agree bit for bit; the signal is the
JAX tool's."""

import importlib.util
import json
import os

import numpy as np
import pytest

from audio_raytracing_studio_tpu_torch.tools import bench_codecs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lines_of(capsys, argv):
    capsys.readouterr()
    rc = bench_codecs.main(argv)
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_lines_carry_the_numbers_the_tier_and_the_device(capsys):
    rc, lines = lines_of(capsys, ["--lengths", "0.3", "--device", "cpu"])
    assert rc == 0
    codecs = [line["codec"] for line in lines]
    assert codecs == list(bench_codecs.CODEC_EXT) + ["pcm16"]
    for line in lines:
        assert line["host_only"] is True and line["device"] == {"name": "cpu"}
        assert line["metric"] == bench_codecs.METRIC and line["clip_s"] == 0.3
        if line["codec"] == "pcm16":
            assert line["available"] and line["bit_equal"] is True
            assert min(line[k] for k in ("native_encode_s", "numpy_encode_s",
                                         "native_decode_s", "numpy_decode_s")) > 0
        elif line["available"]:
            assert line["encode_x_rt"] > 0 and line["decode_x_rt"] > 0 and line["mb"] > 0
            assert line["encode_x_rt"] == pytest.approx(0.3 / line["encode_s"])
            assert isinstance(line["tier"], str)
        else:
            assert set(line) == {"metric", "host_only", "device", "codec", "clip_s",
                                 "available"}


def test_absent_codec_prints_available_false(capsys, monkeypatch):
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    monkeypatch.setattr(mp3io, "encode_available", lambda: False)
    monkeypatch.setattr(lavcio, "encode_available", lambda: False)
    rc, lines = lines_of(capsys, ["--lengths", "0.2", "0.3", "--codecs", "mp3", "m4a",
                                  "--device", "cpu"])
    assert rc == 0
    assert [(line["codec"], line["clip_s"], line["available"]) for line in lines[:4]] == [
        ("mp3", 0.2, False), ("mp3", 0.3, False), ("m4a", 0.2, False), ("m4a", 0.3, False)]
    assert "encode_s" not in lines[0]


def test_ogg_tier_follows_the_lavc_tier(monkeypatch):
    from audio_raytracing_studio_tpu_torch.utils import _native_vorbis, lavcio

    monkeypatch.setattr(lavcio, "decode_available", lambda: False)
    monkeypatch.setattr(_native_vorbis, "available", lambda: False)
    assert bench_codecs.decode_tier("ogg") == "vorbisio"
    monkeypatch.setattr(lavcio, "decode_available", lambda: True)
    assert bench_codecs.decode_tier("ogg") == "lavc"


def test_music_like_is_the_jax_tools_signal():
    spec = importlib.util.spec_from_file_location(
        "root_bench_codecs", os.path.join(REPO, "tools", "bench_codecs.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    np.testing.assert_array_equal(bench_codecs.music_like(0.5), root.music_like(0.5))
    assert bench_codecs.CODEC_EXT == root.CODEC_EXT and bench_codecs.RATE == root.RATE


def test_refuses_cuda_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    rc, lines = lines_of(capsys, ["--lengths", "0.2"])
    assert rc == 1 and len(lines) == 1 and "CUDA" in lines[0]["error"]
