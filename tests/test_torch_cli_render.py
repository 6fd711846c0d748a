"""The port's render CLI (cli/render.py) against the JAX package's on the same
files, on the CPU (``--device cpu``; the JAX CLI runs on JAX's CPU backend).

Tolerances: the written PCM16 within 1 LSB — the renders agree to ~1e-6
(tests/test_torch_pipeline.py), so a sample near a rounding boundary may
land one step apart; metrics within 0.01 LU and 0.01 dB (PARITY.md item 2);
the same JSON keys and the same exit codes.  Each comparison records its gap with ``record_property`` (``--junitxml`` keeps them).
"""

import json

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.cli import render as jcli
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.cli import render as tcli
from audio_raytracing_studio_tpu_torch.utils import wavio
from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore

torch.set_num_threads(1)

RATE = 16000
LU_TOL = 0.01
DB_TOL = 0.01


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_render")
    r = np.random.default_rng(41)
    t = np.arange(RATE // 2) / RATE
    x = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.05 * r.standard_normal(t.shape)
    wavio.write(d / "in.wav", x.astype(np.float32), RATE)
    stereo = np.stack([x, np.roll(x, 37) * 0.8], axis=1)
    wavio.write(d / "in_stereo.wav", stereo.astype(np.float32), RATE)
    ir = r.standard_normal((800, 2)) * np.exp(-np.arange(800) / 150.0)[:, None] * 0.3
    ir[0] = 1.0
    wavio.write(d / "ir.wav", ir.astype(np.float32), 22050, subtype="FLOAT")
    PresetStore(str(d)).save("Small Hall", RenderParams(
        hall_type="Plate", room_size=30.0, diffusion=0.7, dry_wet=0.6, bass_gain=1.3,
        target_layout="7.1 (Surround)"))
    (d / "corrupt.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunkjunk")
    return d


CASES = {
    "plain_json": (["in.wav", "{out}", "--room-size", "50", "--layout", "5.1 (Standard)",
                    "--metrics", "--json", "--seed", "3"], 1),
    "plain_text_metrics": (["in_stereo.wav", "{out}", "--hall", "Room", "--room-size", "40",
                            "--layout", "Stereo", "--air-absorption", "0.4", "--metrics",
                            "--seed", "9"], 1),
    "binaural": (["in.wav", "{out}", "--room-size", "50", "--layout", "5.1 (Standard)",
                  "--binaural", "--json", "--seed", "1"], 1),
    "binaural_512": (["in_stereo.wav", "{out}", "--room-size", "30", "--z", "0.8",
                      "--layout", "5.1.2 (Atmos Light)", "--binaural", "--metrics", "--seed", "4"],
                     1),
    "sweep": (["in.wav", "{out}", "--room-size", "50", "--layout", "Stereo", "--json",
               "--sweep", "diffusion=0.2,0.5,0.8", "--seed", "5"], 3),
    "sweep_binaural": (["in.wav", "{out}", "--room-size", "40", "--sweep", "x_pos=0.1,0.9",
                        "--binaural", "--json"], 2),
    "external_ir": (["in_stereo.wav", "{out}", "--external-ir", "ir.wav", "--layout", "Stereo",
                     "--dry-wet", "0.7", "--bass-gain", "1.6", "--json"], 1),
    "external_ir_sweep": (["in.wav", "{out}", "--external-ir", "ir.wav", "--layout",
                           "5.1 (Standard)", "--sweep", "dry_wet=0.3,0.9", "--json"], 2),
    "preset": (["in.wav", "{out}", "--preset", "Small_Hall_v4.json", "--preset-dir", ".",
                "--json", "--seed", "2"], 1),
}


def run(main, files, argv, out, monkeypatch, capsys):
    monkeypatch.chdir(files)
    capsys.readouterr()
    rc = main([a.replace("{out}", out) for a in argv])
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


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_cli(files, monkeypatch, capsys, record_property, case):
    argv, n_out = CASES[case]
    sweep = n_out > 1 or "--sweep" in argv
    t_out = f"t_{case}" + ("_{i}" if sweep else "") + ".wav"
    j_out = f"j_{case}" + ("_{i}" if sweep else "") + ".wav"
    rc_t, cap_t = run(tcli.main, files, argv + ["--device", "cpu"], t_out, monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, j_out, monkeypatch, capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    for i in range(n_out):
        got, rate = pcm(files / t_out.format(i=i))
        want, want_rate = pcm(files / j_out.format(i=i))
        assert rate == want_rate and got.shape == want.shape
        record_property(f"pcm16_lsb_{i}", int(np.abs(got - want).max()))
        assert np.abs(got - want).max() <= 1
    if "--json" in argv:
        res_t, res_j = json.loads(cap_t.out), json.loads(cap_j.out)
        assert len(res_t) == len(res_j) == n_out
        for a, b in zip(res_t, res_j):
            assert set(a) == set(b)
            a_m, b_m = a.pop("metrics"), b.pop("metrics")
            check_metrics(a_m, b_m, record_property)
            assert a["output"].replace("t_", "j_") == b["output"]
            assert {k: v for k, v in a.items() if k != "output"} == \
                {k: v for k, v in b.items() if k != "output"}
    else:
        lines_t, lines_j = cap_t.out.splitlines(), cap_j.out.splitlines()
        assert len(lines_t) == len(lines_j) == n_out
        for a, b in zip(lines_t, lines_j):
            assert ("LUFS:" in a) == ("LUFS:" in b) == ("--metrics" in argv)


ERROR_CASES = {
    "corrupt_input": (["corrupt.wav", "o.wav"], 1),
    "missing_input": (["nope.wav", "o.wav"], 1),
    "z_pos_sweep": (["in.wav", "o_{i}.wav", "--sweep", "z_pos=0.1,0.9"], 2),
    "sweep_without_placeholder": (["in.wav", "o.wav", "--sweep", "diffusion=0.1,0.9"], 2),
    "sweep_not_numbers": (["in.wav", "o_{i}.wav", "--sweep", "diffusion=a,b"], 2),
    "sweep_no_values": (["in.wav", "o_{i}.wav", "--sweep", "diffusion="], 2),
    "external_sweep_of_hall_param": (["in.wav", "o_{i}.wav", "--external-ir", "ir.wav",
                                      "--sweep", "diffusion=0.1,0.9"], 2),
    "nan_flag": (["in.wav", "o.wav", "--diffusion", "nan"], 2),
    "inf_flag": (["in.wav", "o.wav", "--x", "inf"], 2),
    "missing_preset": (["in.wav", "o.wav", "--preset", "none_v4.json"], 2),
    "mono_external_ir": (["in.wav", "o.wav", "--external-ir", "in.wav"], 2),
    "corrupt_external_ir": (["in.wav", "o.wav", "--external-ir", "corrupt.wav"], 1),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_exit_codes_match_jax(files, monkeypatch, capsys, case):
    argv, code = ERROR_CASES[case]
    rc_t, cap_t = run(tcli.main, files, argv + ["--device", "cpu"], "", monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, "", monkeypatch, capsys)
    assert rc_t == rc_j == code
    assert cap_t.err.startswith("error:") and cap_j.err.startswith("error:")
    assert not (files / "o.wav").exists()


def test_stream_matches_jax_and_the_direct_call(files, monkeypatch, capsys, record_property):
    """``--stream`` renders with the exact filters and PCM16 quantized on the
    device: the file equals ``wavio.write`` of the direct
    ``render_streaming`` call bit for bit, its ``--json`` metrics equal that
    call's, and the JAX CLI's file is within 1 LSB (air and EQ off, so that
    the JAX side compiles no Bluestein transform)."""
    from audio_raytracing_studio_tpu_torch.parallel.streaming import render_streaming

    argv = ["in_stereo.wav", "{out}", "--stream", "--chunk-seconds", "0.2", "--seed", "3",
            "--air-absorption", "0", "--layout", "5.1 (Standard)"]
    rc_t, cap_t = run(tcli.main, files, argv + ["--json", "--device", "cpu"], "s_port.wav",
                      monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, "s_jax.wav", monkeypatch, capsys)
    assert rc_t == rc_j == 0, (cap_t.err, cap_j.err)
    (got, _), (want, _) = pcm(files / "s_port.wav"), pcm(files / "s_jax.wav")
    lsb = int(np.abs(got - want).max())
    record_property("pcm16_lsb_vs_jax", lsb)
    assert got.shape == want.shape and lsb <= 1
    audio, rate = wavio.read(files / "in_stereo.wav")
    p = RenderParams(air_absorption=0.0, target_layout="5.1 (Standard)")
    direct, metrics = render_streaming(audio, rate, p, seed=3, chunk_seconds=0.2,
                                       with_metrics=True, pcm16_output=True,
                                       fast_filters=False, device="cpu")
    wavio.write(files / "s_direct.wav", direct, rate)
    assert (files / "s_port.wav").read_bytes() == (files / "s_direct.wav").read_bytes()
    assert json.loads(cap_t.out) == [{"output": "s_port.wav", "metrics": metrics}]


def test_stream_plus_sweep_exits_2_as_in_jax(files, monkeypatch, capsys):
    argv = ["in.wav", "x{i}.wav", "--stream", "--sweep", "diffusion=0.2,0.8"]
    rc_t, cap_t = run(tcli.main, files, argv + ["--device", "cpu"], "", monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, "", monkeypatch, capsys)
    assert rc_t == rc_j == 2
    assert cap_t.err == cap_j.err and "--stream" in cap_t.err
    assert not (files / "x0.wav").exists()


def test_compressed_output_not_supported(files, monkeypatch, capsys):
    """A WAV rendered to .flac is written (the extension picks the encoder)
    within 1 LSB of the JAX CLI's, and a 5.1 render to .mp3 (two channels at
    most) exits 2 with the JAX CLI's message, writing nothing."""
    rc_t, cap_t = run(tcli.main, files, ["in.wav", "o.flac", "--device", "cpu"], "",
                      monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, ["in.wav", "oj.flac"], "", monkeypatch, capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    (got, rate), (want, want_rate) = pcm(files / "o.flac"), pcm(files / "oj.flac")
    assert rate == want_rate and got.shape == want.shape and np.abs(got - want).max() <= 1
    if codec_missing("mp3"):
        return
    argv = ["in.wav", "o6.mp3", "--layout", "5.1 (Standard)"]
    rc_t, cap_t = run(tcli.main, files, argv + ["--device", "cpu"], "", monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, "", monkeypatch, capsys)
    assert rc_t == rc_j == 2 and cap_t.err == cap_j.err and cap_t.err.startswith("error:")
    assert not (files / "o6.mp3").exists()


def test_no_fallback_without_a_card(files, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    for argv in (["in.wav", "nf.wav"], ["in.wav", "nf_{i}.wav", "--sweep", "diffusion=0.2,0.8"],
                 ["in.wav", "nf.wav", "--device", "cuda:0", "--binaural"]):
        rc, cap = run(tcli.main, files, argv, "", monkeypatch, capsys)
        assert rc != 0 and "CUDA" in cap.err and "--device cpu" in cap.err
        assert not list(files.glob("nf*.wav"))


CODECS_IN = ["flac", "ogg", "mp3"]
CODECS_OUT = ["flac", "ogg", "mp3", "m4a"]


def codec_missing(ext):
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    if ext == "mp3" and not (mp3io.encode_available() and mp3io.decode_available()):
        return "libmp3lame / libmpg123 are not loadable here"
    if ext == "m4a" and not lavcio.decode_available():
        return "the FFmpeg libraries cannot be bound here"
    return None


@pytest.mark.parametrize("out_ext", CODECS_OUT)
@pytest.mark.parametrize("in_ext", CODECS_IN)
def test_codec_inputs_and_outputs_match_jax(files, monkeypatch, capsys, record_property,
                                            in_ext, out_ext):
    """A FLAC / Ogg / MP3 input rendered into a FLAC / Ogg / MP3 / M4A
    output by both CLIs: the same exit code and metrics; FLAC outputs within
    1 LSB (and byte-equal where the PCM16 is); lossy outputs of the same
    shape within 40 dB SNR of the JAX file (the two renders differ by ~1e-6,
    which moves a lossy encoder's quantization only here and there)."""
    for ext in (in_ext, out_ext):
        if codec_missing(ext):
            pytest.skip(codec_missing(ext))
    src = files / f"in.{in_ext}"
    if not src.exists():
        data, rate = wavio.read(files / "in_stereo.wav")
        wavio.write_audio(src, data, rate)
    argv = [src.name, "{out}", "--room-size", "40", "--layout", "Stereo", "--seed", "3",
            "--json"]
    t_out, j_out = f"tc_{in_ext}.{out_ext}", f"jc_{in_ext}.{out_ext}"
    rc_t, cap_t = run(tcli.main, files, argv + ["--device", "cpu"], t_out, monkeypatch, capsys)
    rc_j, cap_j = run(jcli.main, files, argv, j_out, monkeypatch, capsys)
    assert rc_t == rc_j == 0, cap_t.err + cap_j.err
    check_metrics(json.loads(cap_t.out)[0]["metrics"], json.loads(cap_j.out)[0]["metrics"],
                  record_property)
    (got, rate), (want, want_rate) = wavio.read(files / t_out), wavio.read(files / j_out)
    assert rate == want_rate == RATE and got.shape == want.shape
    if out_ext == "flac":
        lsb = int(np.abs(np.rint(got * 32768.0) - np.rint(want * 32768.0)).max())
        record_property("pcm16_lsb", lsb)
        assert lsb <= 1
        if lsb == 0:
            assert (files / t_out).read_bytes() == (files / j_out).read_bytes()
    else:
        err = np.sum((got.astype(np.float64) - want) ** 2)
        snr = float(10 * np.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-30)))
        record_property("snr_vs_jax_db", snr)
        assert snr >= 40.0
