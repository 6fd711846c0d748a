"""The port's lossy codecs against the JAX package's, on the CPU: Ogg/Vorbis
(``utils/vorbisenc`` + ``vorbisio`` with ``_native_vorbis``), MP3
(``utils/mp3io`` over libmpg123 / libmp3lame) and AAC / M4A (``utils/lavcio``
over the FFmpeg libraries, through the port's own build of
``_native/lavc_shim.cc``).

For every case the same seeded input goes through both packages: the
port's encoded bytes equal the JAX package's (the MP4 muxer of the FFmpeg
libraries writes no clock or version that differs between two calls, so
M4A is compared byte for byte too), each package decodes the other's file to
the same samples bit for bit, truncated and corrupt files raise the same
exception class with the same message, ``probe`` and ``info`` agree, and the
native Vorbis loops give the same bytes as the NumPy paths.  The
known-answer checks of the JAX suites that need no second implementation
run on the port's code: the Vorbis channel order, the MP3 gapless length,
the ADTS frames and MP4 boxes parsed by hand.  MP3 and AAC cases skip where
their libraries are absent, and say so.
"""

import io
import struct

import numpy as np
import pytest

from audio_raytracing_studio_tpu.utils import lavcio as jlavc
from audio_raytracing_studio_tpu.utils import mp3io as jmp3
from audio_raytracing_studio_tpu.utils import vorbisenc as jvenc
from audio_raytracing_studio_tpu.utils import vorbisio as jvio
from audio_raytracing_studio_tpu.utils import wavio as jwav
from audio_raytracing_studio_tpu_torch.utils import _native_vorbis
from audio_raytracing_studio_tpu_torch.utils import lavcio as tlavc
from audio_raytracing_studio_tpu_torch.utils import mp3io as tmp3
from audio_raytracing_studio_tpu_torch.utils import vorbisenc as tvenc
from audio_raytracing_studio_tpu_torch.utils import vorbisio as tvio
from audio_raytracing_studio_tpu_torch.utils import wavio as twav

needs_mp3 = pytest.mark.skipif(
    not (tmp3.encode_available() and tmp3.decode_available()),
    reason="libmp3lame / libmpg123 are not loadable here")
needs_lavc = pytest.mark.skipif(not tlavc.decode_available(),
                                reason="the FFmpeg libraries cannot be bound here")


def signal(n, channels, seed, gain=0.3):
    """Seeded tones plus noise, one frequency per channel, float32."""
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.stack([np.sin(2 * np.pi * (0.01 + 0.003 * c) * t) for c in range(channels)], axis=1)
    return (gain * x + 0.05 * r.standard_normal((n, channels))).astype(np.float32)


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
    return rx == ry and np.array_equal(np.asarray(x), np.asarray(y))


def both_written(tmp_path, ext, x, rate, **kw):
    """The port's and the JAX package's ``write_audio`` of ``x`` → paths."""
    t, j = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    twav.write_audio(t, x, rate, **kw)
    jwav.write_audio(j, x, rate, **kw)
    return t, j


def assert_cross_decodes(t, j, *decoders):
    """Each package's decoder on the other's file gives the same samples."""
    assert t.read_bytes() == j.read_bytes()
    for port_fn, jax_fn in decoders:
        got, want = outcome(port_fn, j), outcome(jax_fn, t)
        assert got[0] == "ok" and same_outcome(got, want), (got[0], want[0])


def assert_truncations_raise_alike(tmp_path, raw, ext, cuts):
    for cut in cuts:
        path = tmp_path / f"cut_{cut}.{ext}"
        path.write_bytes(raw[:cut if isinstance(cut, int) else int(cut * len(raw))])
        for fn in ("read", "probe", "info"):
            got, want = outcome(getattr(twav, fn), path), outcome(getattr(jwav, fn), path)
            assert same_outcome(got, want), (cut, fn, got, want)


# --------------------------------------------------------------- Vorbis ---


@pytest.mark.parametrize("rate", [8000, 44100, 96000])
@pytest.mark.parametrize("channels", [1, 2, 6, 8])
def test_vorbis_bytes_and_samples_equal_jax(tmp_path, rate, channels):
    x = signal(int(0.15 * rate) + 77, channels, seed=rate + channels)
    t, j = both_written(tmp_path, "ogg", x, rate)
    assert_cross_decodes(t, j, (tvio.decode, jvio.decode), (twav.read, jwav.read))
    # the in-repo decoder trims to the granule position: the exact length.
    # (``wavio.read`` goes through lavc first where it loads, which in both
    # packages pads a stream that ends on its first page to the last block.)
    assert tvio.decode(t)[0].shape == x.shape


@pytest.mark.parametrize("kbps", [64, 128, 320])
def test_vorbis_quality_for_bitrate_equal_jax(kbps):
    x = signal(9000, 2, seed=kbps)
    q = tvenc.quality_for_bitrate(kbps)
    assert q == jvenc.quality_for_bitrate(kbps)
    a, b = io.BytesIO(), io.BytesIO()
    tvenc.encode(x, 16000, a, quality=q)
    jvenc.encode(x, 16000, b, quality=q)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("cuts", [(4, 30, 60), (0.3, 0.6, 0.97)])
def test_truncated_vorbis_raises_as_jax(tmp_path, cuts):
    t, _ = both_written(tmp_path, "ogg", signal(20000, 2, seed=3), 16000)
    raw = t.read_bytes()
    assert_truncations_raise_alike(tmp_path, raw, "ogg", cuts)
    for cut in cuts:  # the in-repo decoder's own message, past the lavc tier
        blob = raw[:cut if isinstance(cut, int) else int(cut * len(raw))]
        assert same_outcome(outcome(tvio.decode, io.BytesIO(blob)),
                            outcome(jvio.decode, io.BytesIO(blob)))


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_vorbis_raises_as_jax(tmp_path, seed):
    """Flipped bits: the Ogg page CRC catches them, with the same message."""
    t, _ = both_written(tmp_path, "ogg", signal(12000, 2, seed=4), 16000)
    raw = bytearray(t.read_bytes())
    rng = np.random.default_rng(seed)
    for _ in range(1 + seed):
        raw[int(rng.integers(30, len(raw)))] ^= 1 << int(rng.integers(0, 8))
    path = tmp_path / "flip.ogg"
    path.write_bytes(bytes(raw))
    assert same_outcome(outcome(twav.read, path), outcome(jwav.read, path))
    got = outcome(tvio.decode, path)
    assert got[0] == "ValueError" and same_outcome(got, outcome(jvio.decode, path))


def test_vorbis_probe_and_info_equal_jax(tmp_path):
    t, _ = both_written(tmp_path, "ogg", signal(30000, 6, seed=5), 44100)
    for fn in ("probe", "info"):
        got = outcome(getattr(twav, fn), t)
        assert got[0] == "ok" and got == outcome(getattr(jwav, fn), t)
    assert tvio.probe(t) == jvio.probe(t)


def test_vorbis_native_tier_equals_numpy_tier(monkeypatch, tmp_path):
    x = signal(20000, 2, seed=6)
    native = io.BytesIO()
    tvenc.encode(x, 22050, native)
    decoded = tvio.decode(io.BytesIO(native.getvalue()))[0]
    assert _native_vorbis.available()
    monkeypatch.setattr(_native_vorbis, "available", lambda: False)
    plain = io.BytesIO()
    tvenc.encode(x, 22050, plain)
    assert plain.getvalue() == native.getvalue()
    np.testing.assert_array_equal(tvio.decode(io.BytesIO(native.getvalue()))[0], decoded)
    assert tvio.ogg_crc(native.getvalue()[:300]) == jvio.ogg_crc(native.getvalue()[:300])


def test_vorbis_channel_tables_are_inverses():
    assert tvio.WAV_FROM_VORBIS == jvio.WAV_FROM_VORBIS
    for ch, perm in tvio.WAV_FROM_VORBIS.items():
        inv = tvio.VORBIS_FROM_WAV[ch]
        assert sorted(perm) == list(range(ch))
        assert [perm[inv[j]] for j in range(ch)] == list(range(ch))


@pytest.mark.parametrize("channels", [3, 6, 8])
def test_vorbis_channel_order_round_trip(tmp_path, channels):
    """Encode in WAV order, spec order on the wire, WAV order decoded: each
    decoded channel correlates with its own source, by the in-repo decoder
    and (where it loads) by libavcodec, an independent one."""
    r = np.random.default_rng(0x0C0 + channels)
    x = np.stack([0.2 * r.standard_normal(30000) for _ in range(channels)],
                 axis=1).astype(np.float32)
    path = tmp_path / f"order{channels}.ogg"
    tvenc.write(path, x, 44100)
    decoders = [tvio.decode] + ([tlavc.decode] if tlavc.decode_available() else [])
    for decode in decoders:
        out = np.asarray(decode(path)[0])
        n = min(len(out), len(x))
        for k in range(channels):
            cors = [abs(np.corrcoef(out[:n, k], x[:n, j])[0, 1]) for j in range(channels)]
            assert int(np.argmax(cors)) == k and max(cors) > 0.9, (decode, k, cors)


# ------------------------------------------------------------------ MP3 ---


@needs_mp3
@pytest.mark.parametrize("kbps", [96, 256])
@pytest.mark.parametrize("rate", [8000, 22050, 44100, 48000])
@pytest.mark.parametrize("channels", [1, 2])
def test_mp3_bytes_and_samples_equal_jax(tmp_path, channels, rate, kbps):
    x = signal(int(0.2 * rate) + 31, channels, seed=rate + channels + kbps)
    t, j = tmp_path / "t.mp3", tmp_path / "j.mp3"
    tmp3.write(t, x, rate, bitrate_kbps=kbps)
    jmp3.write(j, x, rate, bitrate_kbps=kbps)
    assert_cross_decodes(t, j, (tmp3.decode, jmp3.decode), (twav.read, jwav.read))
    # gapless: the LAME tag restores the exact sample count at the input rate
    data, got_rate = tmp3.decode(t)
    assert got_rate == rate and data.shape == x.shape


@needs_mp3
def test_truncated_and_junk_mp3_raise_as_jax(tmp_path):
    x = signal(20000, 2, seed=9)
    raw = tmp3.encode(x, 44100)
    assert raw == jmp3.encode(x, 44100)
    assert_truncations_raise_alike(tmp_path, raw, "mp3", (3, 50, 0.5))
    path = tmp_path / "junk.mp3"
    path.write_bytes(b"\xff\xfb\xf0\x00" + b"\x00" * 4096)
    for fn in ("read", "probe"):
        got, want = outcome(getattr(twav, fn), path), outcome(getattr(jwav, fn), path)
        assert same_outcome(got, want), (fn, got, want)


@needs_mp3
@pytest.mark.parametrize("bad", ["six_channels", "empty", "nan"])
def test_mp3_encoder_refuses_as_jax(bad):
    x = {"six_channels": np.zeros((1000, 6), np.float32),
         "empty": np.zeros((0, 2), np.float32),
         "nan": np.full((4096, 2), np.nan, np.float32)}[bad]
    got, want = outcome(tmp3.encode, x, 48000), outcome(jmp3.encode, x, 48000)
    assert got[0] == "ValueError" and got == want


@needs_mp3
def test_mp3_probe_and_id3_prefix_equal_jax(tmp_path):
    x = signal(30000, 2, seed=10)
    raw = tmp3.encode(x, 44100)
    tag = b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10  # an empty ID3v2 tag
    path = tmp_path / "tagged.mp3"
    path.write_bytes(tag + raw)
    for fn in ("read", "probe", "info"):
        got = outcome(getattr(twav, fn), path)
        assert got[0] == "ok" and same_outcome(got, outcome(getattr(jwav, fn), path))
    assert twav.read(path)[0].shape == x.shape


# ------------------------------------------------------------ AAC / M4A ---


@needs_lavc
@pytest.mark.parametrize("ext", ["m4a", "aac"])
@pytest.mark.parametrize("rate", [8000, 44100, 96000])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_aac_bytes_and_samples_equal_jax(tmp_path, channels, rate, ext):
    x = signal(int(0.2 * rate) + 11, channels, seed=rate + channels)
    t, j = both_written(tmp_path, ext, x, rate)
    assert_cross_decodes(t, j, (tlavc.decode, jlavc.decode), (twav.read, jwav.read))
    for fn in ("probe", "info"):
        got = outcome(getattr(twav, fn), t)
        assert same_outcome(got, outcome(getattr(jwav, fn), t)), fn


@needs_lavc
def test_aac_truncation_and_refusals_as_jax(tmp_path):
    t, _ = both_written(tmp_path, "m4a", signal(40000, 2, seed=12), 48000)
    assert_truncations_raise_alike(tmp_path, t.read_bytes(), "m4a", (16, 0.125))
    for x, rate in ((signal(1000, 2, seed=1), 12345), (np.zeros((0, 2), np.float32), 48000)):
        got = outcome(tlavc.encode_aac, str(tmp_path / "r.m4a"), x, rate)
        assert got[0] == "ValueError"
        assert got == outcome(jlavc.encode_aac, str(tmp_path / "rj.m4a"), x, rate)


ADTS_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025,
              8000, 7350]


@needs_lavc
def test_adts_frames_by_hand(tmp_path):
    """Every ADTS header of the port's .aac: sync, layer 00, AAC-LC, the
    rate index and mono config; the frame lengths tile the file."""
    path = tmp_path / "clip.aac"
    tlavc.encode_aac(str(path), signal(48000, 1, seed=13), 48000, bitrate_kbps=128)
    blob = path.read_bytes()
    pos = frames = 0
    while pos < len(blob):
        h = blob[pos:pos + 7]
        assert len(h) == 7 and h[0] == 0xFF and (h[1] & 0xF0) == 0xF0 and (h[1] & 0x06) == 0
        assert (h[2] >> 6) & 0x3 == 1 and ADTS_RATES[(h[2] >> 2) & 0xF] == 48000
        assert (((h[2] & 0x1) << 2) | ((h[3] >> 6) & 0x3)) == 1
        frame_len = ((h[3] & 0x03) << 11) | (h[4] << 3) | ((h[5] >> 5) & 0x7)
        assert 7 <= frame_len <= len(blob) - pos
        pos += frame_len
        frames += 1
    assert pos == len(blob) and 48 <= frames <= 50  # 1 s + 1024 priming, ≤ 2 flush frames


@needs_lavc
def test_mp4_boxes_by_hand(tmp_path):
    path = tmp_path / "clip.m4a"
    tlavc.encode_aac(str(path), signal(48000, 2, seed=14), 48000)
    blob = path.read_bytes()
    boxes, pos = {}, 0
    while pos + 8 <= len(blob):
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        if size == 1:
            size = struct.unpack(">Q", blob[pos + 8:pos + 16])[0]
        assert size >= 8 and pos + size <= len(blob)
        boxes[kind] = size
        pos += size
    assert pos == len(blob) and {b"ftyp", b"moov", b"mdat"} <= set(boxes)
    data, rate = tlavc.decode(str(path))
    assert rate == 48000 and 48000 <= data.shape[0] <= 48000 + 1024
