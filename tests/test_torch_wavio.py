"""The port's audio I/O (utils/wavio.py) against the JAX package's on the
same files: reads bit-equal, written files byte-identical, probe dicts
equal, the same ValueError messages for corrupt headers, and for the other
containers (FLAC, Ogg, MP3, AAC / M4A, compressed AIFC) the same outcome —
the same samples or the same exception class and message.  The codecs
themselves are held to the JAX package's in tests/test_torch_codecs.py."""

import math
import struct

import numpy as np
import pytest

from audio_raytracing_studio_tpu.utils import wavio as jwav
from audio_raytracing_studio_tpu_torch.utils import wavio as twav


def wav_bytes(tag, bits, channels, rate, payload, extensible=False, before_data=b""):
    """A RIFF/WAVE file around ``payload``; ``extensible`` wraps the format
    tag in a WAVE_FORMAT_EXTENSIBLE header; ``before_data`` is spliced in as
    extra chunks."""
    block = channels * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, rate, rate * block, block, bits,
                          22, bits, 0x3F)
        fmt += struct.pack("<H", tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, rate, rate * block, block, bits)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt + before_data
    body += b"data" + struct.pack("<I", len(payload)) + payload + (b"\x00" if len(payload) & 1 else b"")
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def aiff_bytes(values, rate, bits=16, form=b"AIFF", comp=None):
    """An AIFF / AIFC file around integer (or float32 'fl32') samples."""
    e = math.floor(math.log2(rate))
    f80 = (16383 + e).to_bytes(2, "big") + int(rate * 2 ** (63 - e)).to_bytes(8, "big")
    n, ch = values.shape
    comm = ch.to_bytes(2, "big") + n.to_bytes(4, "big") + bits.to_bytes(2, "big") + f80
    if comp is not None:
        comm += comp + b"\x00"
    if comp == b"sowt":
        pcm = values.astype("<i2").tobytes()
    elif comp == b"fl32":
        pcm = values.astype(">f4").tobytes()
    elif bits == 24:
        v = values.astype(np.int64).reshape(-1) & 0xFFFFFF
        pcm = b"".join(int(s).to_bytes(3, "big") for s in v)
    else:
        pcm = values.astype({8: ">i1", 32: ">i4"}.get(bits, ">i2")).tobytes()
    ssnd = (0).to_bytes(8, "big") + pcm
    body = b"COMM" + len(comm).to_bytes(4, "big") + comm + (b"\x00" if len(comm) & 1 else b"")
    body += b"SSND" + len(ssnd).to_bytes(4, "big") + ssnd + (b"\x00" if len(ssnd) & 1 else b"")
    return b"FORM" + (4 + len(body)).to_bytes(4, "big") + form + body


def make_case(name, rng):
    ints = lambda bits, shape: rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), size=shape)  # noqa: E731
    if name == "pcm8":
        return wav_bytes(1, 8, 2, 8000, rng.integers(0, 256, size=600, dtype=np.uint8).tobytes())
    if name == "pcm16":
        return wav_bytes(1, 16, 2, 44100, ints(16, 800).astype("<i2").tobytes())
    if name == "pcm24":
        v = ints(24, 900).astype(np.int64) & 0xFFFFFF
        return wav_bytes(1, 24, 3, 48000, b"".join(int(s).to_bytes(3, "little") for s in v))
    if name == "pcm32":
        return wav_bytes(1, 32, 1, 96000, ints(32, 500).astype("<i4").tobytes())
    if name == "float32":
        return wav_bytes(3, 32, 2, 48000, rng.uniform(-1, 1, 400).astype("<f4").tobytes())
    if name == "float64":
        return wav_bytes(3, 64, 1, 22050, rng.uniform(-1, 1, 300).astype("<f8").tobytes())
    if name == "extensible_pcm16":
        return wav_bytes(1, 16, 6, 48000, ints(16, 1200).astype("<i2").tobytes(), extensible=True)
    if name == "extensible_float32":
        return wav_bytes(3, 32, 2, 16000, rng.uniform(-1, 1, 200).astype("<f4").tobytes(),
                         extensible=True)
    if name == "odd_chunks":
        # a LIST chunk of odd size (pad byte) before data, and an odd data
        # size: 8-bit mono, 301 bytes
        odd = b"LIST" + struct.pack("<I", 5) + b"abcde" + b"\x00"
        return wav_bytes(1, 8, 1, 8000, rng.integers(0, 256, size=301, dtype=np.uint8).tobytes(),
                         before_data=odd)
    if name == "aiff16":
        return aiff_bytes(ints(16, (500, 2)), 44100)
    if name == "aiff8":
        return aiff_bytes(ints(8, (300, 1)), 8000, bits=8)
    if name == "aiff24":
        return aiff_bytes(ints(24, (200, 2)), 48000, bits=24)
    if name == "aiff32":
        return aiff_bytes(ints(32, (100, 1)), 32000, bits=32)
    if name == "aifc_sowt":
        return aiff_bytes(ints(16, (300, 1)), 8000, form=b"AIFC", comp=b"sowt")
    if name == "aifc_fl32":
        return aiff_bytes(rng.uniform(-1, 1, (250, 2)), 48000, bits=32, form=b"AIFC",
                          comp=b"fl32")
    raise KeyError(name)


READ_CASES = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64", "extensible_pcm16",
              "extensible_float32", "odd_chunks", "aiff16", "aiff8", "aiff24", "aiff32",
              "aifc_sowt", "aifc_fl32"]


@pytest.mark.parametrize("case", READ_CASES)
def test_read_and_probe_equal_jax(tmp_path, rng, case):
    path = tmp_path / ("x.aiff" if case.startswith("aif") else "x.wav")
    path.write_bytes(make_case(case, rng))
    got, rate = twav.read(path)
    want, want_rate = jwav.read(path)
    assert rate == want_rate and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[0] > 0
    assert np.array_equal(got, want)
    assert twav.probe(path) == jwav.probe(path)


def test_stream_read_equal_jax(rng):
    import io

    blob = make_case("pcm16", rng)
    got, rate = twav.read(io.BytesIO(blob))
    want, want_rate = jwav.read(io.BytesIO(blob))
    assert rate == want_rate and np.array_equal(got, want)


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
@pytest.mark.parametrize("kind", ["float_mono_1d", "float_stereo", "float_6ch", "int16_stereo",
                                  "int16_8ch", "float_over_full_scale"])
def test_write_byte_identical(tmp_path, rng, kind, subtype):
    if kind == "float_mono_1d":
        data = rng.uniform(-1, 1, 999).astype(np.float32)
    elif kind == "float_stereo":
        data = rng.uniform(-1, 1, (700, 2)).astype(np.float32)
    elif kind == "float_6ch":
        data = rng.uniform(-1, 1, (300, 6)).astype(np.float64)
    elif kind == "int16_stereo":
        data = rng.integers(-32768, 32768, (500, 2)).astype(np.int16)
    elif kind == "int16_8ch":
        data = rng.integers(-32768, 32768, (64, 8)).astype(np.int16)
    else:
        data = rng.uniform(-1.5, 1.5, (400, 2)).astype(np.float32)
        data[0, 0], data[1, 1] = 1.0, -1.0
    twav.write(tmp_path / "t.wav", data, 48000, subtype=subtype)
    jwav.write(tmp_path / "j.wav", data, 48000, subtype=subtype)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    twav.write_audio(tmp_path / "ta.wav", data, 44100, subtype=subtype)
    jwav.write_audio(tmp_path / "ja.wav", data, 44100, subtype=subtype)
    assert (tmp_path / "ta.wav").read_bytes() == (tmp_path / "ja.wav").read_bytes()


def test_pcm16_codec_equal_jax(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 5000), (np.arange(-8, 9) + 0.5) / 32768.0,
                        [1.0, -1.0, 0.99997]]).astype(np.float32)
    assert np.array_equal(twav.encode_pcm16(x), jwav.encode_pcm16(x))
    raw = rng.integers(-32768, 32768, 4000).astype(np.int16)
    assert np.array_equal(twav.decode_pcm16(raw), jwav.decode_pcm16(raw))


def corrupt(name, rng):
    good = make_case("pcm16", rng)
    fmt_at = good.index(b"fmt ")
    if name == "garbage":
        return b"not a wav file at all"
    if name == "riff_no_chunks":
        return b"RIFFxxxxWAVEjunk"
    if name == "truncated_fmt":
        return b"RIFF" + struct.pack("<I", 100) + b"WAVE" + b"fmt " + struct.pack("<I", 8) + b"12345678"
    if name == "no_data":
        return good[: good.index(b"data")]
    if name == "zero_channels":
        blob = bytearray(good)
        blob[fmt_at + 10 : fmt_at + 12] = (0).to_bytes(2, "little")
        return bytes(blob)
    if name == "bad_format":
        return wav_bytes(2, 4, 1, 8000, b"\x00" * 16)
    if name.startswith("rate_"):
        blob = bytearray(good)
        blob[fmt_at + 12 : fmt_at + 16] = int(name[5:]).to_bytes(4, "little")
        return bytes(blob)
    if name == "aiff_truncated_chunk":
        return aiff_bytes(np.zeros((50, 1), np.int16), 8000)[:-20]
    if name == "aiff_no_ssnd":
        blob = aiff_bytes(np.zeros((50, 1), np.int16), 8000)
        return blob[: blob.index(b"SSND")]
    if name == "aiff_bad_depth":
        return aiff_bytes(np.zeros((50, 1), np.int16), 8000, bits=12)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["garbage", "riff_no_chunks", "truncated_fmt", "no_data",
                                  "zero_channels", "bad_format", "rate_2147491648",
                                  f"rate_{twav.MAX_SAMPLE_RATE + 1}", "rate_0",
                                  "aiff_truncated_chunk", "aiff_no_ssnd", "aiff_bad_depth"])
def test_corrupt_headers_raise_the_same_errors(tmp_path, rng, case):
    path = tmp_path / "bad.wav"
    path.write_bytes(corrupt(case, rng))
    raised = 0
    for fn in ("read", "probe"):
        try:
            getattr(jwav, fn)(path)
        except ValueError as e:
            want = str(e)
        else:
            continue  # the JAX package accepts it (probe reads headers only)
        with pytest.raises(ValueError) as got:
            getattr(twav, fn)(path)
        assert str(got.value) == want
        raised += 1
    assert raised


def test_rate_ceiling_is_legal(tmp_path, rng):
    blob = bytearray(make_case("pcm16", rng))
    fmt_at = blob.index(b"fmt ")
    blob[fmt_at + 12 : fmt_at + 16] = twav.MAX_SAMPLE_RATE.to_bytes(4, "little")
    path = tmp_path / "r.wav"
    path.write_bytes(bytes(blob))
    assert twav.read(path)[1] == twav.MAX_SAMPLE_RATE == jwav.read(path)[1]
    assert twav.probe(path) == jwav.probe(path)


def outcome(fn, *args):
    """("ok", result) or (exception class name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)


def same_outcome(a, b):
    if a[0] != b[0]:
        return False
    if a[0] != "ok":
        return a[1] == b[1]
    if isinstance(a[1], dict):
        return a[1] == b[1]
    (x, rx), (y, ry) = a[1], b[1]
    return rx == ry and np.array_equal(x, y)


@pytest.mark.parametrize("head", [
    b"fLaC" + b"\x00" * 8, b"OggS" + b"\x00" * 8, b"ID3\x04" + b"\x00" * 8,
    b"\xff\xfbxx" + b"\x00" * 8, b"\x00\x00\x00 ftypM4A " + b"\x00" * 4,
    b"\xff\xf1\x50\x80" + b"\x00" * 8,
])
def test_other_containers_not_supported(tmp_path, head):
    """A corrupt file of each other container: the JAX package's outcome
    (class and message) from read and probe."""
    name = twav.sniff_container(head)
    assert name == jwav.sniff_container(head) and name not in (None, "WAV", "AIFF")
    path = tmp_path / "x.bin"
    path.write_bytes(head + b"\x00" * 64)
    for fn in ("read", "probe", "info"):
        got, want = outcome(getattr(twav, fn), path), outcome(getattr(jwav, fn), path)
        assert same_outcome(got, want), (fn, got, want)
        assert got[0] != "ok" or fn != "read"  # no samples out of a corrupt header


@pytest.mark.parametrize("ext", [".flac", ".ogg", ".mp3", ".aac", ".m4a", ".mp4"])
def test_compressed_outputs_not_supported(tmp_path, ext, rng):
    """Every compressed output extension writes the JAX package's bytes
    (the MP3 and AAC cases where their libraries load)."""
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    if ext == ".mp3" and not mp3io.encode_available():
        pytest.skip("libmp3lame is not loadable here")
    if ext in (".aac", ".m4a", ".mp4") and not lavcio.encode_available():
        pytest.skip("the FFmpeg libraries cannot be bound here")
    x = (0.3 * rng.standard_normal((4800, 2))).astype(np.float32)
    twav.write_audio(tmp_path / f"t{ext}", x, 48000)
    jwav.write_audio(tmp_path / f"j{ext}", x, 48000)
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    assert same_outcome(outcome(twav.read, tmp_path / f"t{ext}"),
                        outcome(jwav.read, tmp_path / f"t{ext}"))


def test_compressed_aifc_not_supported(tmp_path):
    """μ-law AIFC: past the in-repo AIFF reader to the universal tiers, with
    the JAX package's outcome."""
    path = tmp_path / "c.aifc"
    path.write_bytes(aiff_bytes(np.zeros((10, 1), np.int16), 8000, form=b"AIFC", comp=b"ulaw"))
    got, want = outcome(twav.read, path), outcome(jwav.read, path)
    assert same_outcome(got, want), (got, want)


@pytest.mark.parametrize("head", [b"RIFF\x00\x00\x00\x00WAVE", b"FORM\x00\x00\x00\x00AIFF",
                                  b"FORM\x00\x00\x00\x00AIFC", b"garbage bytes",
                                  b"\xff\xfa\x90\x00", b"\xff\xe3\x18\xc4", b"\xff\xf0\x00\x00",
                                  b"\xff\xfa\xf4\xc4", b"\xff\xfa\x9c\xc4", b"\xff\xfa\x04\xc4"])
def test_sniff_container_equal_jax(head):
    assert twav.sniff_container(head) == jwav.sniff_container(head)
