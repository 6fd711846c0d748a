"""The port's directory renderer (cli/render_dir.py) against the JAX package's
on the same directory, on the CPU (``--device cpu``).

Three clips of different lengths (two length buckets at 16 kHz, one of
them split into micro-batches by ``--batch 2``), one of them AIFF with the
same stem as a WAV (unique output names), plus files both renderers skip.
Tolerances: each written PCM16 within 1 LSB, metrics within 0.01 LU and
0.01 dB, the same JSON keys and exit codes.  Each comparison records its gap with ``record_property`` (``--junitxml`` keeps them).
"""

import json
import math

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.cli import render_dir as jcli
from audio_raytracing_studio_tpu_torch.cli import render_dir as tcli
from audio_raytracing_studio_tpu_torch.utils import wavio

torch.set_num_threads(1)

RATE = 16000
LU_TOL = 0.01
DB_TOL = 0.01


def aiff16(path, x, rate):
    """A 16-bit big-endian AIFF file of float samples in [-1, 1)."""
    e = math.floor(math.log2(rate))
    f80 = (16383 + e).to_bytes(2, "big") + int(rate * 2 ** (63 - e)).to_bytes(8, "big")
    n, ch = x.shape
    comm = ch.to_bytes(2, "big") + n.to_bytes(4, "big") + (16).to_bytes(2, "big") + f80
    ssnd = bytes(8) + wavio.encode_pcm16(x).astype(">i2").tobytes()
    body = b"COMM" + len(comm).to_bytes(4, "big") + comm
    body += b"SSND" + len(ssnd).to_bytes(4, "big") + ssnd
    path.write_bytes(b"FORM" + (4 + len(body)).to_bytes(4, "big") + b"AIFF" + body)


def tone(seconds, channels, seed):
    r = np.random.default_rng(seed)
    t = np.arange(int(seconds * RATE)) / RATE
    x = 0.4 * np.sin(2 * np.pi * (220 + 60 * seed) * t) + 0.05 * r.standard_normal(t.shape)
    return np.stack([x * (1.0 - 0.2 * c) for c in range(channels)], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def indir(tmp_path_factory):
    d = tmp_path_factory.mktemp("render_dir_in")
    wavio.write(d / "a.wav", tone(0.2, 1, 1), RATE)
    aiff16(d / "a.aiff", tone(0.45, 2, 2), RATE)
    wavio.write(d / "b.wav", tone(0.7, 2, 3), RATE)
    (d / "corrupt.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunkjunk")
    wavio.write(d / "empty.wav", np.zeros((0, 1), np.float32), RATE)
    (d / "notes.txt").write_text("not audio")
    return d


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    return rc, capsys.readouterr()


def pcm(path):
    data, rate = wavio.read(path)
    return np.rint(data * 32768.0).astype(np.int32), rate


def check_metrics(got, want, record_property):
    assert set(got) == set(want)
    for k in got:
        if np.isinf(want[k]):
            assert got[k] == want[k]
        else:
            record_property(k, abs(got[k] - want[k]))
            assert abs(got[k] - want[k]) <= (LU_TOL if k == "lufs" else DB_TOL), (k, got, want)


@pytest.mark.parametrize("flags", [
    ["--metrics", "--json", "--room-size", "40", "--seed", "7"],
    ["--binaural", "--layout", "5.1 (Standard)", "--metrics", "--json", "--room-size", "30",
     "--bass-gain", "1.4"],
    ["--layout", "Stereo", "--room-size", "50", "--treble-gain", "0.7"],
])
def test_matches_jax(indir, tmp_path, capsys, record_property, flags):
    argv = ["--batch", "2", *flags]
    rc_t, cap_t = run(tcli.main, [indir, tmp_path / "t", *argv, "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, [indir, tmp_path / "j", *argv], capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == ["a.wav", "a_1.wav", "b.wav"]
    for name in names:
        got, rate = pcm(tmp_path / "t" / name)
        want, want_rate = pcm(tmp_path / "j" / name)
        assert rate == want_rate == RATE and got.shape == want.shape
        assert got.shape[1] == (2 if "--binaural" in flags or "Stereo" in flags else 6)
        record_property(f"pcm16_lsb_{name}", int(np.abs(got - want).max()))
        assert np.abs(got - want).max() <= 1
    for skipped in ("corrupt.wav", "empty.wav"):
        assert f"skipping {skipped}" in cap_t.err and f"skipping {skipped}" in cap_j.err
    if "--json" in flags:
        res_t, res_j = json.loads(cap_t.out), json.loads(cap_j.out)
        assert set(res_t) == set(res_j) >= {"clips", "audio_seconds", "realtime_factor"}
        assert res_t["audio_seconds"] == res_j["audio_seconds"]
        assert len(res_t["clips"]) == len(res_j["clips"]) == 3
        for a, b in zip(res_t["clips"], res_j["clips"]):
            assert a["output"].replace(str(tmp_path / "t"), "") == \
                b["output"].replace(str(tmp_path / "j"), "")
            check_metrics(a["metrics"], b["metrics"], record_property)
    else:
        assert cap_t.out.splitlines()[-1].startswith("# 3 clips")


def test_output_length_is_clip_plus_ir(indir, tmp_path, capsys):
    rc, _ = run(tcli.main, [indir, tmp_path / "t", "--batch", "2", "--room-size", "40",
                            "--device", "cpu"], capsys)
    assert rc == 0
    n = {name: wavio.read(tmp_path / "t" / name)[0].shape[0]
         for name in ("a.wav", "a_1.wav", "b.wav")}
    # a.aiff sorts before a.wav, so it keeps the name a.wav; every clip has
    # an IR of the same length, so the outputs differ by the input lengths
    assert n["a.wav"] - n["a_1.wav"] == int(0.45 * RATE) - int(0.2 * RATE)
    assert n["b.wav"] - n["a_1.wav"] == int(0.7 * RATE) - int(0.2 * RATE)


@pytest.mark.parametrize("case", ["external_ir", "empty_dir", "missing_dir", "nan_flag"])
def test_errors_match_jax(indir, tmp_path, capsys, case):
    if case == "external_ir":
        argv, code = [indir, tmp_path / "o", "--external-ir", indir / "b.wav"], 2
    elif case == "empty_dir":
        (tmp_path / "empty").mkdir()
        argv, code = [tmp_path / "empty", tmp_path / "o"], 1
    elif case == "missing_dir":
        argv, code = [tmp_path / "missing", tmp_path / "o"], 1
    else:
        argv, code = [indir, tmp_path / "o", "--room-size", "nan"], 2
    rc_t, cap_t = run(tcli.main, argv + ["--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, argv, capsys)
    assert rc_t == rc_j == code
    assert cap_t.err.splitlines()[-1] == cap_j.err.splitlines()[-1]
    assert not (tmp_path / "o").exists() or not list((tmp_path / "o").iterdir())


def test_only_unsupported_files(tmp_path, capsys):
    """A directory whose one file is a corrupt FLAC: both renderers skip it
    with the same message and exit 1."""
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "x.flac").write_bytes(b"fLaC" + bytes(60))
    rc_t, cap_t = run(tcli.main, [tmp_path / "in", tmp_path / "o", "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, [tmp_path / "in", tmp_path / "oj"], capsys)
    assert rc_t == rc_j == 1
    assert cap_t.err == cap_j.err
    assert "skipping x.flac: " in cap_t.err and "no readable audio files" in cap_t.err


def snr_db(want, got):
    err = np.sum((got.astype(np.float64) - want) ** 2)
    return float(10 * np.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-30)))


def test_mixed_codec_directory_matches_jax(tmp_path, capsys, record_property):
    """WAV, FLAC, Ogg, AIFF and (where their libraries load) MP3 and M4A in
    one directory, plus a corrupt FLAC: the same outputs (.flac and .ogg
    kept, the rest as WAV), PCM16 within 1 LSB for the lossless ones, Ogg
    within 40 dB SNR of the JAX file, metrics within 0.01 LU / dB, the same
    skip message."""
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    d = tmp_path / "in"
    d.mkdir()
    wavio.write_audio(d / "a.wav", tone(0.3, 1, 1), RATE)
    wavio.write_audio(d / "b.flac", tone(0.45, 2, 2), RATE)
    wavio.write_audio(d / "c.ogg", tone(0.6, 2, 3), RATE)
    aiff16(d / "d.aiff", tone(0.35, 2, 4), RATE)
    names = ["a.wav", "b.flac", "c.ogg", "d.wav"]
    if mp3io.encode_available() and mp3io.decode_available():
        wavio.write_audio(d / "e.mp3", tone(0.5, 2, 5), RATE)
        names.append("e.wav")
    if lavcio.encode_available() and lavcio.decode_available():
        wavio.write_audio(d / "f.m4a", tone(0.55, 1, 6), RATE)
        names.append("f.wav")
    (d / "g.flac").write_bytes(b"fLaC" + bytes(10))
    argv = [d, None, "--batch", "2", "--layout", "Stereo", "--metrics", "--json", "--seed", "4"]
    rc_t, cap_t = run(tcli.main, [a if a else tmp_path / "t" for a in argv]
                      + ["--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, [a if a else tmp_path / "j" for a in argv], capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == sorted(names)
    for name in names:
        (got, rate), (want, want_rate) = (wavio.read(tmp_path / w / name) for w in "tj")
        assert rate == want_rate == RATE and got.shape == want.shape and got.shape[1] == 2
        if name.endswith(".ogg"):
            record_property(f"snr_db_{name}", snr_db(want, got))
            assert snr_db(want, got) >= 40.0
        else:
            lsb = int(np.abs(np.rint(got * 32768.0) - np.rint(want * 32768.0)).max())
            record_property(f"pcm16_lsb_{name}", lsb)
            assert lsb <= 1
    assert "skipping g.flac: invalid FLAC STREAMINFO block" in cap_t.err
    assert cap_t.err == cap_j.err
    res_t, res_j = json.loads(cap_t.out), json.loads(cap_j.out)
    assert res_t["audio_seconds"] == res_j["audio_seconds"]
    for a, b in zip(res_t["clips"], res_j["clips"]):
        assert a["output"].replace(str(tmp_path / "t"), "") == \
            b["output"].replace(str(tmp_path / "j"), "")
        check_metrics(a["metrics"], b["metrics"], record_property)


def test_no_fallback_without_a_card(indir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    rc, cap = run(tcli.main, [indir, tmp_path / "o", "--metrics"], capsys)
    assert rc != 0 and "CUDA" in cap.err and "--device cpu" in cap.err
    assert not (tmp_path / "o").exists()
