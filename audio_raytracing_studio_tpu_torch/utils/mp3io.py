"""MP3 I/O via the system codec shared libraries (ctypes — no subprocess,
no pip package).

Decode: libmpg123 (MPEG-1/2/2.5 audio, layers I/II/III → float32).
Encode: libmp3lame (CBR Layer III, with the Xing/LAME gapless tag patched
in via ``lame_get_lametag_frame`` so a round trip restores the exact
sample count).

The port's own copy of ``audio_raytracing_studio_tpu/utils/mp3io.py``.
The reference converts mp3 via pydub, which shells out to the ffmpeg
BINARY (its analyser.py:73-83), and reads mp3 the same way (its
raytracer_studio.py:1013 falls through libsndfile to ffmpeg).  Binding the
system codec libraries directly removes both the
binary dependency and the subprocess round trip.  When a library is
absent, ``decode_available()``/``encode_available()`` return False and
the callers (utils/wavio.py, cli/analyzer.py) fall through to the
soundfile/ffmpeg tiers with the same error contract as before.

Validation note: the two libraries are INDEPENDENT codebases (LAME
encodes, mpg123 decodes), so the round-trip tests of both packages
cross-validate each binding against the other — the same interop
discipline as the FLAC and Vorbis suites.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
from typing import Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# library loading
# ---------------------------------------------------------------------------


def _load(candidates, short_name: str) -> Optional[ctypes.CDLL]:
    names = list(candidates)
    found = ctypes.util.find_library(short_name)
    if found and found not in names:
        names.append(found)
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


# -- mpg123 constants (mpg123.h; stable public ABI values) ------------------
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_ADD_FLAGS = 2  # enum mpg123_parms
_MPG123_QUIET = 0x20
_MPG123_GAPLESS = 0x40  # default on in modern builds; set explicitly
_MPG123_FORCE_FLOAT = 0x400
_MPG123_ENC_FLOAT_32 = 0x200

# -- lame constants (lame.h) ------------------------------------------------
_LAME_JOINT_STEREO = 1
_LAME_MONO = 3
# MPEG-1 / MPEG-2 / MPEG-2.5 sample rates — when the input rate is one of
# these, the output rate is pinned to it (LAME would otherwise silently
# resample low-bitrate encodes down, breaking round-trip rate invariance)
_MPEG_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)


@functools.lru_cache(maxsize=None)
def _mpg123() -> Optional[ctypes.CDLL]:
    lib = _load(["libmpg123.so.0", "libmpg123.so"], "mpg123")
    if lib is None:
        return None
    c = ctypes
    lib.mpg123_init()  # no-op on modern versions, required on old ones
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_strerror.argtypes = [c.c_void_p]
    lib.mpg123_plain_strerror.restype = c.c_char_p
    lib.mpg123_plain_strerror.argtypes = [c.c_int]
    lib.mpg123_param.restype = c.c_int
    lib.mpg123_param.argtypes = [c.c_void_p, c.c_int, c.c_long, c.c_double]
    # 64-bit off_t builds may export only the _64-suffixed large-file names
    for base in ("mpg123_open", "mpg123_length", "mpg123_scan"):
        if not hasattr(lib, base) and hasattr(lib, base + "_64"):
            setattr(lib, base, getattr(lib, base + "_64"))
    lib.mpg123_open.restype = c.c_int
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_close.restype = c.c_int
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_getformat.restype = c.c_int
    lib.mpg123_getformat.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_long),
        c.POINTER(c.c_int),
        c.POINTER(c.c_int),
    ]
    lib.mpg123_format_none.restype = c.c_int
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.restype = c.c_int
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_read.restype = c.c_int
    lib.mpg123_read.argtypes = [
        c.c_void_p,
        c.c_void_p,
        c.c_size_t,
        c.POINTER(c.c_size_t),
    ]
    if hasattr(lib, "mpg123_scan"):
        lib.mpg123_scan.restype = c.c_int
        lib.mpg123_scan.argtypes = [c.c_void_p]
    if hasattr(lib, "mpg123_length"):
        lib.mpg123_length.restype = c.c_long
        lib.mpg123_length.argtypes = [c.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _lame() -> Optional[ctypes.CDLL]:
    lib = _load(["libmp3lame.so.0", "libmp3lame.so"], "mp3lame")
    if lib is None:
        return None
    c = ctypes
    lib.lame_init.restype = c.c_void_p
    lib.lame_init.argtypes = []
    lib.lame_close.restype = c.c_int
    lib.lame_close.argtypes = [c.c_void_p]
    for setter in (
        "lame_set_in_samplerate",
        "lame_set_out_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_mode",
        "lame_set_quality",
    ):
        fn = getattr(lib, setter)
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_int]
    lib.lame_init_params.restype = c.c_int
    lib.lame_init_params.argtypes = [c.c_void_p]
    lib.lame_encode_buffer_ieee_float.restype = c.c_int
    lib.lame_encode_buffer_ieee_float.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_float),
        c.POINTER(c.c_float),
        c.c_int,
        c.POINTER(c.c_ubyte),
        c.c_int,
    ]
    lib.lame_encode_flush.restype = c.c_int
    lib.lame_encode_flush.argtypes = [c.c_void_p, c.POINTER(c.c_ubyte), c.c_int]
    if hasattr(lib, "lame_get_lametag_frame"):
        lib.lame_get_lametag_frame.restype = c.c_size_t
        lib.lame_get_lametag_frame.argtypes = [
            c.c_void_p,
            c.POINTER(c.c_ubyte),
            c.c_size_t,
        ]
    return lib


def decode_available() -> bool:
    """True when libmpg123 is loadable here."""
    return _mpg123() is not None


def encode_available() -> bool:
    """True when libmp3lame is loadable here."""
    return _lame() is not None


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _mpg_err(lib, handle) -> str:
    try:
        msg = lib.mpg123_strerror(handle)
        return msg.decode("utf-8", "replace") if msg else "unknown mpg123 error"
    except Exception:  # pragma: no cover - defensive
        return "unknown mpg123 error"


class _Mpg123Handle:
    """Opened mpg123 handle with forced-float output and known format."""

    def __init__(self, path: Union[str, os.PathLike]):
        lib = _mpg123()
        if lib is None:
            raise RuntimeError(
                "libmpg123 nicht verfügbar — MP3-Dekodierung benötigt "
                "libmpg123, soundfile oder ffmpeg"
            )
        self.lib = lib
        err = ctypes.c_int(0)
        self.h = lib.mpg123_new(None, ctypes.byref(err))
        if not self.h:
            raise ValueError(
                lib.mpg123_plain_strerror(err.value).decode("utf-8", "replace")
            )
        self.opened = False
        lib.mpg123_param(
            self.h,
            _MPG123_ADD_FLAGS,
            _MPG123_QUIET | _MPG123_GAPLESS | _MPG123_FORCE_FLOAT,
            0.0,
        )
        if lib.mpg123_open(self.h, os.fsencode(os.fspath(path))) != _MPG123_OK:
            msg = _mpg_err(lib, self.h)
            lib.mpg123_delete(self.h)
            self.h = None
            raise ValueError(f"MP3 open failed: {msg}")
        self.opened = True
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(
            self.h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc)
        ) != _MPG123_OK:
            msg = _mpg_err(lib, self.h)
            self.close()
            raise ValueError(f"MP3 stream has no decodable frames: {msg}")
        self.rate = int(rate.value)
        self.channels = int(ch.value)
        # lock the negotiated format so mid-stream variants error instead of
        # silently changing shape
        lib.mpg123_format_none(self.h)
        lib.mpg123_format(self.h, self.rate, self.channels, _MPG123_ENC_FLOAT_32)

    def close(self) -> None:
        if self.h is not None:
            if self.opened:
                self.lib.mpg123_close(self.h)
            self.lib.mpg123_delete(self.h)
            self.h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, int]:
    """Decode an MPEG audio file → (float32 (frames, channels), rate).

    Raises ``ValueError`` for streams with no decodable frames (garbage
    behind a plausible sync word, hard truncation before the first frame)
    and ``RuntimeError`` when libmpg123 is absent.  A stream truncated
    mid-frame decodes to the frames that preceded it (mpg123 resyncs),
    matching typical player behavior for a lossy transport format.
    """
    with _Mpg123Handle(path) as m:
        lib = m.lib
        buf = np.empty(1 << 16, dtype=np.float32)
        buf_ptr = buf.ctypes.data_as(ctypes.c_void_p)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            ret = lib.mpg123_read(m.h, buf_ptr, buf.nbytes, ctypes.byref(done))
            if done.value:
                chunks.append(buf[: done.value // 4].copy())
            if ret == _MPG123_DONE or ret == _MPG123_NEED_MORE:
                break
            if ret == _MPG123_NEW_FORMAT:
                raise ValueError(
                    "MP3 stream changes format mid-stream (unsupported)"
                )
            if ret != _MPG123_OK:
                raise ValueError(f"MP3 decode error: {_mpg_err(lib, m.h)}")
        if not chunks:
            raise ValueError("MP3 stream contains no audio frames")
        flat = np.concatenate(chunks)
        frames = flat.shape[0] // m.channels
        return flat[: frames * m.channels].reshape(frames, m.channels), m.rate


def probe(path: Union[str, os.PathLike]) -> dict:
    """Header-level info (rate/channels/frames/duration) via mpg123_scan.

    ``bits`` is 0 — lossy streams have no PCM bit depth (same convention
    as vorbisio.probe).
    """
    with _Mpg123Handle(path) as m:
        frames = 0
        if hasattr(m.lib, "mpg123_scan") and hasattr(m.lib, "mpg123_length"):
            m.lib.mpg123_scan(m.h)
            n = int(m.lib.mpg123_length(m.h))
            frames = max(n, 0)
        return {
            "samplerate": m.rate,
            "channels": m.channels,
            "bits": 0,
            "frames": frames,
            "duration": frames / m.rate if m.rate > 0 else 0.0,
        }


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode(data: np.ndarray, rate: int, bitrate_kbps: int = 256) -> bytes:
    """Encode float32 PCM → CBR MP3 bytes (Layer III, joint stereo/mono).

    ``data``: (frames,) or (frames, channels≤2) in [-1, 1].  The emitted
    stream carries a patched Xing/LAME tag (encoder delay + padding), so
    gapless-aware decoders — including :func:`decode` — restore exactly
    ``frames`` samples.  When ``rate`` is a standard MPEG rate the output
    rate is pinned to it at every bitrate (LAME would otherwise resample
    low-bitrate encodes down); non-MPEG rates let LAME pick the nearest.
    """
    lib = _lame()
    if lib is None:
        raise RuntimeError(
            "libmp3lame nicht verfügbar — MP3-Ausgabe benötigt libmp3lame "
            "oder ffmpeg"
        )
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, np.newaxis]
    frames, channels = data.shape
    if frames == 0:
        raise ValueError("cannot encode an empty signal to MP3")
    if not np.all(np.isfinite(data)):
        # libmp3lame ABORTS the whole process on non-finite samples
        # (psymodel.c calc_energy assertion) — a crafted float WAV upload
        # converted to .mp3 would otherwise kill the analyzer/serving
        # process.  Found by tools/fuzz_campaign.py encode mode.
        raise ValueError("cannot encode non-finite samples (NaN/Inf) to MP3")
    if channels > 2:
        raise ValueError(
            f"MP3 unterstützt maximal 2 Kanäle (Eingabe: {channels}) — "
            f"bitte zuerst abmischen oder WAV/FLAC als Ziel wählen"
        )
    g = lib.lame_init()
    if not g:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(g, int(rate))
        if int(rate) in _MPEG_RATES:
            lib.lame_set_out_samplerate(g, int(rate))
        lib.lame_set_num_channels(g, channels)
        lib.lame_set_brate(g, int(bitrate_kbps))
        lib.lame_set_mode(g, _LAME_MONO if channels == 1 else _LAME_JOINT_STEREO)
        lib.lame_set_quality(g, 2)
        if lib.lame_init_params(g) < 0:
            raise ValueError(
                f"lame_init_params failed (rate={rate}, "
                f"bitrate={bitrate_kbps} kbps, channels={channels})"
            )
        left = np.ascontiguousarray(data[:, 0])
        right = np.ascontiguousarray(data[:, -1])
        fptr = ctypes.POINTER(ctypes.c_float)
        step = 1 << 16
        mp3buf = (ctypes.c_ubyte * (step * 2 + 7200))()
        out = bytearray()
        for start in range(0, frames, step):
            n = min(step, frames - start)
            ret = lib.lame_encode_buffer_ieee_float(
                g,
                left[start:].ctypes.data_as(fptr),
                right[start:].ctypes.data_as(fptr),
                n,
                mp3buf,
                len(mp3buf),
            )
            if ret < 0:
                raise ValueError(f"lame encode error {ret}")
            out += bytes(mp3buf[:ret])
        ret = lib.lame_encode_flush(g, mp3buf, len(mp3buf))
        if ret < 0:
            raise ValueError(f"lame flush error {ret}")
        out += bytes(mp3buf[:ret])
        # Overwrite the placeholder first frame with the real Xing/LAME tag
        # (delay/padding bookkeeping) — this is what makes decode gapless.
        if hasattr(lib, "lame_get_lametag_frame"):
            tag = (ctypes.c_ubyte * 8192)()
            nt = int(lib.lame_get_lametag_frame(g, tag, len(tag)))
            if 0 < nt <= len(tag) and nt <= len(out):
                out[:nt] = bytes(tag[:nt])
        return bytes(out)
    finally:
        lib.lame_close(g)


def write(
    path: Union[str, os.PathLike],
    data: np.ndarray,
    rate: int,
    bitrate_kbps: int = 256,
) -> None:
    """Encode and write an .mp3 file (see :func:`encode`)."""
    payload = encode(data, rate, bitrate_kbps=bitrate_kbps)
    with open(path, "wb") as fh:
        fh.write(payload)
