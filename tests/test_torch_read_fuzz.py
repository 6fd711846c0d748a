"""Cross-format fuzz of the port's unified read path
(``audio_raytracing_studio_tpu_torch/utils/wavio.read``) — the port's copy
of ``tests/test_read_fuzz.py``.

The per-codec truncation tests (``tests/test_torch_codecs.py``,
``tests/test_torch_codecs_lossy.py``) reach each decoder directly; this
module fuzzes the sniff-and-dispatch layer that untrusted uploads hit
(the port's HTTP studio and job API → ``wavio.read``): for every container,
truncations and bit flips of a real file, plus magic-prefixed and pure
garbage, must either decode or raise a clean ValueError.  Any other
exception type would reach the user as a raw traceback, and a crash in a
native library would take the server process down.  MP3 and M4A cases are
skipped where their codec libraries do not load.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from audio_raytracing_studio_tpu_torch.utils import wavio

RATE = 8000


@pytest.fixture(scope="module")
def tone():
    t = np.arange(RATE // 2, dtype=np.float32) / RATE
    sig = 0.4 * np.sin(2 * np.pi * 220.0 * t)
    return np.stack([sig, 0.8 * sig], axis=1).astype(np.float32)


FORMATS = ["wav", "flac", "ogg", "aiff", "mp3", "m4a"]


def _require_codec(fmt: str) -> None:
    """Skip an MP3 / M4A case where its codec library does not load here.
    Decided inside the test, so every worker collects the same cases."""
    from audio_raytracing_studio_tpu_torch.utils import lavcio, mp3io

    if fmt == "mp3" and not (mp3io.encode_available() and mp3io.decode_available()):
        pytest.skip("libmp3lame / libmpg123 do not load here")
    if fmt == "m4a" and not (lavcio.encode_available() and lavcio.decode_available()):
        pytest.skip("the FFmpeg libraries do not load here")


def _write(fmt: str, tone: np.ndarray, path: str) -> None:
    _require_codec(fmt)
    if fmt == "aiff":
        # write_audio has no AIFF target; hand-roll a minimal AIFF-C-free
        # AIFF (COMM + SSND) around 16-bit big-endian PCM
        import struct

        pcm = np.clip(tone, -1.0, 1.0)
        ints = np.rint(pcm * 32767.0).astype(">i2")
        frames, channels = ints.shape
        ssnd_body = b"\x00" * 8 + ints.tobytes()
        # 80-bit extended float for the sample rate
        def ext80(v: float) -> bytes:
            import math

            m, e = math.frexp(v)
            return struct.pack(">hQ", e + 16382, int(m * (1 << 64)))

        comm = struct.pack(">hLh", channels, frames, 16) + ext80(float(RATE))
        chunks = (
            b"COMM" + struct.pack(">L", len(comm)) + comm
            + b"SSND" + struct.pack(">L", len(ssnd_body)) + ssnd_body
        )
        form = b"AIFF" + chunks
        with open(path, "wb") as f:
            f.write(b"FORM" + struct.pack(">L", len(form)) + form)
        return
    wavio.write_audio(path, tone, RATE)


def _assert_clean(path: str) -> None:
    """read() must return data or raise ValueError — nothing else."""
    try:
        data, rate = wavio.read(path)
    except ValueError:
        return
    assert isinstance(data, np.ndarray)
    assert rate > 0
    assert data.size == 0 or np.all(np.isfinite(data))


@pytest.mark.parametrize("fmt", FORMATS)
class TestReadFuzz:
    def test_roundtrip_baseline(self, fmt, tone, tmp_path):
        path = str(tmp_path / f"base.{fmt}")
        _write(fmt, tone, path)
        data, rate = wavio.read(path)
        assert rate > 0 and data.shape[0] > 0

    def test_truncations(self, fmt, tone, tmp_path):
        path = str(tmp_path / f"t.{fmt}")
        _write(fmt, tone, path)
        blob = open(path, "rb").read()
        # headers, mid-metadata, mid-frame, near-end
        cuts = sorted({1, 2, 3, 4, 7, 11, 16, 32, 63, len(blob) // 4,
                       len(blob) // 2, len(blob) - 7, len(blob) - 1})
        for cut in cuts:
            if cut <= 0 or cut >= len(blob):
                continue
            p = str(tmp_path / f"cut_{cut}.{fmt}")
            with open(p, "wb") as f:
                f.write(blob[:cut])
            _assert_clean(p)

    def test_bit_flips(self, fmt, tone, tmp_path):
        path = str(tmp_path / f"b.{fmt}")
        _write(fmt, tone, path)
        blob = bytearray(open(path, "rb").read())
        rng = np.random.default_rng(0xC0DEC)
        # deterministic spread: header region + random body positions
        positions = list(range(0, min(48, len(blob)), 5))
        positions += [int(x) for x in rng.integers(0, len(blob), size=12)]
        for pos in positions:
            flipped = bytearray(blob)
            flipped[pos] ^= 1 << int(rng.integers(0, 8))
            p = str(tmp_path / f"flip_{pos}.{fmt}")
            with open(p, "wb") as f:
                f.write(bytes(flipped))
            _assert_clean(p)

    def test_magic_prefixed_garbage(self, fmt, tone, tmp_path):
        path = str(tmp_path / f"g.{fmt}")
        _write(fmt, tone, path)
        head = open(path, "rb").read()[:16]
        rng = np.random.default_rng(0xBADF00D)
        for n in (0, 5, 300, 4096):
            p = str(tmp_path / f"garbage_{n}.{fmt}")
            with open(p, "wb") as f:
                f.write(head + rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
            _assert_clean(p)


def test_pure_garbage_and_empty(tmp_path):
    rng = np.random.default_rng(1)
    p = str(tmp_path / "noise.bin")
    with open(p, "wb") as f:
        f.write(rng.integers(0, 256, size=2048, dtype=np.uint8).tobytes())
    _assert_clean(p)
    p = str(tmp_path / "empty.bin")
    open(p, "wb").close()
    _assert_clean(p)
    assert not os.path.exists(str(tmp_path / "missing.wav"))
    with pytest.raises((ValueError, OSError)):
        wavio.read(str(tmp_path / "missing.wav"))
