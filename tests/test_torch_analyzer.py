"""The port's analyzer CLI (cli/analyzer.py) and polyphase resampler
(ops/resample.resample_poly) against the JAX package's, on the CPU.

Tolerances: LUFS within 0.01 LU and peaks within 0.01 dB (PARITY.md item
2); written PCM16 within 1 LSB; ``resample_poly`` ≤ 1e-5 max-abs — one
float32 correlation with the same float32 taps, summed in another order
(the port computes only the kept outputs, the JAX package convolves the
zero-stuffed signal).  Each comparison records its gap with ``record_property`` (``--junitxml`` keeps them).
"""

import json

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.cli import analyzer as jcli
from audio_raytracing_studio_tpu.ops import resample as jresample
from audio_raytracing_studio_tpu_torch.cli import analyzer as tcli
from audio_raytracing_studio_tpu_torch.ops import resample as tresample
from audio_raytracing_studio_tpu_torch.utils import wavio

torch.set_num_threads(1)

LU_TOL = 0.01
DB_TOL = 0.01
RESAMPLE_TOL = 1e-5


def signal(n, channels, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.3 * np.sin(2 * np.pi * 0.013 * t)[:, None] + 0.1 * r.standard_normal((n, channels))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyzer")
    wavio.write(d / "music.wav", signal(8000, 2, 1) * 1.5, 16000)  # peaks past full scale
    wavio.write(d / "quiet.wav", signal(12000, 1, 2) * 0.05, 16000)
    wavio.write(d / "six.wav", signal(28800, 6, 3), 48000)
    wavio.write(d / "short.wav", signal(6000, 2, 6), 48000)  # under one 400 ms block
    wavio.write(d / "at44k1.wav", signal(22050, 2, 4), 44100, subtype="FLOAT")
    wavio.write(d / "silent.wav", np.zeros((4000, 2), np.float32), 16000)
    wavio.write(d / "at8k.wav", signal(4000, 1, 5), 8000)
    return d


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    return rc, capsys.readouterr()


def pcm(path):
    data, rate = wavio.read(path)
    return np.rint(data * 32768.0).astype(np.int32), rate


@pytest.mark.parametrize("name", ["music.wav", "quiet.wav", "six.wav", "at44k1.wav",
                                  "silent.wav", "short.wav"])
def test_analyze_matches_jax(files, capsys, record_property, name):
    rc_t, cap_t = run(tcli.main, ["analyze", files / name, "--true-peak", "--device", "cpu"],
                      capsys)
    rc_j, cap_j = run(jcli.main, ["analyze", files / name, "--true-peak"], capsys)
    assert rc_t == rc_j == 0
    got, want = json.loads(cap_t.out), json.loads(cap_j.out)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], float):
            tol = LU_TOL if k == "LUFS" else DB_TOL
            gap = 0.0 if got[k] == want[k] else abs(got[k] - want[k])
            record_property(k, gap)
            assert gap <= tol, (k, got[k], want[k])
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("name, target", [("music.wav", -16.0), ("quiet.wav", -23.0),
                                          ("six.wav", -14.0)])
def test_normalize_matches_jax(files, tmp_path, capsys, record_property, name, target):
    rc_t, cap_t = run(tcli.main, ["normalize", files / name, tmp_path / "t.wav", "--target",
                                  str(target), "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, ["normalize", files / name, tmp_path / "j.wav", "--target",
                                  str(target)], capsys)
    assert rc_t == rc_j == 0
    got, want = json.loads(cap_t.out), json.loads(cap_j.out)
    assert set(got) == set(want) and got["clipped"] == want["clipped"]
    for k in ("input_lufs", "gain_db", "output_lufs"):
        record_property(k, abs(got[k] - want[k]))
        assert abs(got[k] - want[k]) <= LU_TOL, (k, got, want)
    a, rate = pcm(tmp_path / "t.wav")
    b, want_rate = pcm(tmp_path / "j.wav")
    assert rate == want_rate and a.shape == b.shape
    record_property("pcm16_lsb", int(np.abs(a - b).max()))
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("name", ["silent.wav", "short.wav"])
def test_normalize_unmeasurable_fails_like_jax(files, tmp_path, capsys, name):
    rc_t, cap_t = run(tcli.main, ["normalize", files / name, tmp_path / "t.wav",
                                  "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, ["normalize", files / name, tmp_path / "j.wav"], capsys)
    assert rc_t == rc_j == 1 and cap_t.err == cap_j.err
    assert not (tmp_path / "t.wav").exists()


@pytest.mark.parametrize("src, rate_out, extra", [
    ("at44k1.wav", 48000, []), ("six.wav", 16000, []), ("at8k.wav", 44100, []),
    ("music.wav", 16000, []), ("short.wav", 44100, []),
    ("at44k1.wav", 48000, ["--bitrate", "160"]),  # accepted and unused for WAV, as in JAX
])
def test_convert_matches_jax(files, tmp_path, capsys, record_property, src, rate_out, extra):
    rc_t, _ = run(tcli.main, ["convert", files / src, tmp_path / "t.wav", "--samplerate",
                              rate_out, *extra, "--device", "cpu"], capsys)
    rc_j, _ = run(jcli.main, ["convert", files / src, tmp_path / "j.wav", "--samplerate",
                              rate_out, *extra], capsys)
    assert rc_t == rc_j == 0
    a, rate = pcm(tmp_path / "t.wav")
    b, want_rate = pcm(tmp_path / "j.wav")
    assert rate == want_rate == rate_out and a.shape == b.shape
    record_property("pcm16_lsb", int(np.abs(a - b).max()))
    assert np.abs(a - b).max() <= 1


def codec_missing(ext):
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    if ext == ".mp3" and not (mp3io.encode_available() and mp3io.decode_available()):
        return "libmp3lame / libmpg123 are not loadable here"
    if ext in (".m4a", ".aac") and not lavcio.decode_available():
        return "the FFmpeg libraries cannot be bound here"
    return None


@pytest.mark.parametrize("target", ["o.flac", "o.mp3", "o.ogg", "o.m4a", "o.aiff"])
def test_convert_to_other_containers_not_supported(files, tmp_path, capsys, target):
    """Every conversion target of the JAX CLI: the same bytes (no rate change,
    so the same samples reach the same encoder); a target no tier writes
    (.aiff without the ffmpeg binary) fails with the JAX CLI's error."""
    ext = target[target.index("."):]
    if codec_missing(ext):
        pytest.skip(codec_missing(ext))
    rc_t, cap_t = run(tcli.main, ["convert", files / "music.wav", tmp_path / ("t" + target),
                                  "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, ["convert", files / "music.wav", tmp_path / ("j" + target)],
                      capsys)
    assert rc_t == rc_j and cap_t.err == cap_j.err
    if rc_t == 0:
        assert (tmp_path / ("t" + target)).read_bytes() == \
            (tmp_path / ("j" + target)).read_bytes()
    else:
        assert ext == ".aiff" and cap_t.err.startswith("error: ffmpeg not found")
        assert not (tmp_path / ("t" + target)).exists()


def snr_db(want, got):
    err = np.sum((got.astype(np.float64) - want) ** 2)
    return float(10 * np.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-30)))


@pytest.mark.parametrize("src_ext, dst_ext, extra", [
    (".flac", ".ogg", ["--samplerate", "48000", "--bitrate", "128"]),
    (".ogg", ".flac", ["--samplerate", "16000"]),
    (".mp3", ".m4a", ["--samplerate", "44100", "--bitrate", "160"]),
    (".flac", ".mp3", ["--samplerate", "32000", "--bitrate", "192"]),
    (".m4a", ".wav", []),
])
def test_convert_codecs_with_rate_change_match_jax(files, tmp_path, capsys, record_property,
                                                   src_ext, dst_ext, extra):
    """Compressed inputs to compressed outputs through ``resample_poly``:
    lossless outputs within 1 LSB of the JAX CLI's, lossy ones of the same
    shape within 40 dB SNR (Vorbis, MP3) or 20 dB (AAC, whose psychoacoustic
    decisions move with the ≤ 1e-5 between the two resamplers) of the JAX
    file."""
    for ext in (src_ext, dst_ext):
        if codec_missing(ext):
            pytest.skip(codec_missing(ext))
    src = tmp_path / ("in" + src_ext)
    wavio.write_audio(src, signal(24000, 2, 7), 24000)
    rc_t, cap_t = run(tcli.main, ["convert", src, tmp_path / ("t" + dst_ext), *extra,
                                  "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, ["convert", src, tmp_path / ("j" + dst_ext), *extra], capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    (a, rate), (b, want_rate) = (wavio.read(tmp_path / (w + dst_ext)) for w in "tj")
    assert rate == want_rate and a.shape == b.shape
    if dst_ext in (".flac", ".wav"):
        lsb = int(np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max())
        record_property("pcm16_lsb", lsb)
        assert lsb <= 1
    else:
        record_property("snr_db", snr_db(b, a))
        assert snr_db(b, a) >= (20.0 if dst_ext == ".m4a" else 40.0)


@pytest.mark.parametrize("ext", [".flac", ".ogg", ".mp3"])
def test_normalize_codecs_match_jax(files, tmp_path, capsys, record_property, ext):
    """normalize from and to FLAC / Ogg / MP3: the JAX CLI's report within
    0.01 LU / dB, the FLAC output within 1 LSB, the lossy ones within 40 dB
    SNR of the JAX file."""
    if codec_missing(ext):
        pytest.skip(codec_missing(ext))
    src = tmp_path / ("in" + ext)
    wavio.write_audio(src, signal(32000, 2, 8) * 0.2, 32000)
    rc_t, cap_t = run(tcli.main, ["normalize", src, tmp_path / ("t" + ext), "--target", "-18",
                                  "--device", "cpu"], capsys)
    rc_j, cap_j = run(jcli.main, ["normalize", src, tmp_path / ("j" + ext), "--target", "-18"],
                      capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    got, want = json.loads(cap_t.out), json.loads(cap_j.out)
    assert got["clipped"] == want["clipped"]
    for k in ("input_lufs", "gain_db", "output_lufs"):
        record_property(k, abs(got[k] - want[k]))
        assert abs(got[k] - want[k]) <= LU_TOL
    (a, rate), (b, want_rate) = (wavio.read(tmp_path / (w + ext)) for w in "tj")
    assert rate == want_rate == 32000 and a.shape == b.shape
    if ext == ".flac":
        assert np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max() <= 1
    else:
        record_property("snr_db", snr_db(b, a))
        assert snr_db(b, a) >= 40.0


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate_in, rate_out", [(44100, 48000), (48000, 16000), (8000, 44100),
                                               (48000, 44100), (16000, 16000)])
def test_resample_poly_matches_jax(record_property, rate_in, rate_out, channels):
    x = signal(rate_in // 10 + 7, channels, seed=rate_in + channels)
    if channels == 1:
        x = x[:, 0]
    got = tresample.resample_poly(x, rate_out, rate_in)
    want = np.asarray(jresample.resample_poly(x, rate_out, rate_in))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.shape[0] == -(-x.shape[0] * rate_out // rate_in)
    err = float(np.abs(got.numpy() - want).max())
    record_property("max_abs", err)
    assert err <= RESAMPLE_TOL


@pytest.mark.parametrize("n", [2, 3, 40])
def test_resample_poly_short_inputs_match_jax(n):
    x = signal(n, 2, seed=n)
    got = tresample.resample_poly(torch.from_numpy(x), 48000, 44100)
    want = np.asarray(jresample.resample_poly(x, 48000, 44100))
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= RESAMPLE_TOL


def test_resample_poly_rejects_degenerate():
    with pytest.raises(ValueError):
        tresample.resample_poly(np.zeros(1, np.float32), 48000, 44100)
    with pytest.raises(ValueError):
        tresample.resample_poly(np.zeros(10, np.float32), 48000, 0)


def test_no_fallback_without_a_card(files, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    for argv in (["analyze", files / "music.wav"],
                 ["normalize", files / "music.wav", tmp_path / "n.wav"],
                 ["convert", files / "music.wav", tmp_path / "c.wav", "--samplerate", "48000"]):
        rc, cap = run(tcli.main, argv, capsys)
        assert rc != 0 and "CUDA" in cap.err and "--device cpu" in cap.err
        assert cap.out == ""
    assert not list(tmp_path.iterdir())
