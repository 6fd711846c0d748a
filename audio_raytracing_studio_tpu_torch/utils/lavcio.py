"""Audio I/O through the system FFmpeg LIBRARIES (no ffmpeg binary) — the
port's own copy of ``audio_raytracing_studio_tpu/utils/lavcio.py``.

The reference needs the ffmpeg *binary* for every format outside its native
readers (pydub shell-out in its analyser.py:73-83; the FFmpeg note at
raytracer_studio.py:1396).  A compiled C shim (``_native/lavc_shim.cc``,
built at first use against the system FFmpeg 5.1 headers by
``kernels.build_host``) binds the libraries directly:

* ``decode(path)`` — the first audio stream of ANYTHING libavformat can
  demux → interleaved float32.  Used as the tier just ahead of the
  ffmpeg-binary fallback in utils/wavio, which makes AAC/ADTS, M4A/MP4
  (AAC or ALAC), Opus-in-Ogg, WMA, compressed AIFC … all readable with
  zero external processes.  The native WAV/FLAC/AIFF/Vorbis/MP3 decoders
  stay first — this tier only catches what they decline.
* ``encode_aac(path, data, rate)`` — FFmpeg's native AAC-LC encoder into
  ADTS ``.aac`` or MP4/M4A (picked from the extension), closing the last
  conversion target the analyzer CLI had to gate on the ffmpeg binary
  (reference parity: analyser.py:73-83 converts to aac through the same
  codec, one subprocess further away).

Availability is probed lazily; on images without the FFmpeg libraries or
dev headers every ``*_available()`` returns False and callers keep the
exact install-ffmpeg error contract they had before this tier existed.

Validation caveat (unlike mp3io, where LAME and mpg123 are independent
codebases): encode and decode both go through libavcodec, so a round trip
alone cannot prove spec compliance.  The tests therefore also
parse the emitted ADTS frame headers / MP4 box structure against the
specs by hand, and checks the decoded signal's spectrum against the
encoded sine's known frequency — the same known-answer discipline the
FLAC suite uses where no second implementation exists.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple, Union

import numpy as np

from . import _native_lavc

_ERRLEN = 512


@functools.lru_cache(maxsize=None)
def _shim():
    try:
        return _native_lavc.lib()
    except Exception:
        return None


def decode_available() -> bool:
    return _shim() is not None


def encode_available() -> bool:
    return _shim() is not None


def decode(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, int]:
    """Decode the first audio stream → ((frames, channels) float32, rate).

    Raises ValueError with the libav error text on any demux/decode
    failure (truncated file, unsupported codec, no audio stream …).
    """
    lib = _shim()
    if lib is None:
        raise RuntimeError("FFmpeg libraries not available")
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_longlong()
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    ret = lib.lavc_decode_file(
        os.fspath(path).encode(), ctypes.byref(out), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate), err, _ERRLEN,
    )
    if ret != 0:
        raise ValueError(err.value.decode("utf-8", "replace"))
    try:
        n = frames.value * channels.value
        data = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.lavc_free_buffer(out)
    return data.reshape(frames.value, channels.value), rate.value


def probe(path: Union[str, os.PathLike]) -> dict:
    """Header-level info without decoding samples.  ``frames`` is the
    container's declared/estimated count (0 = unknown, e.g. raw ADTS)."""
    lib = _shim()
    if lib is None:
        raise RuntimeError("FFmpeg libraries not available")
    frames = ctypes.c_longlong()
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    ret = lib.lavc_probe_file(
        os.fspath(path).encode(), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate), err, _ERRLEN,
    )
    if ret != 0:
        raise ValueError(err.value.decode("utf-8", "replace"))
    r = rate.value
    return {
        "samplerate": r,
        "channels": channels.value,
        "bits": 0,  # lossy/compressed: no PCM bit depth
        "frames": int(frames.value),
        "duration": frames.value / r if r > 0 else 0.0,
    }


def encode_aac(
    path: Union[str, os.PathLike],
    data: np.ndarray,
    rate: int,
    bitrate_kbps: int = 192,
) -> None:
    """Encode (frames,) or (frames, channels) float32 → AAC-LC.

    The container comes from the extension (``.aac`` → ADTS, ``.m4a`` /
    ``.mp4`` → MP4).  The encoder accepts the standard AAC rate table
    (96000 … 7350); other rates raise — resample first (the analyzer CLI's
    --samplerate flag does this on device).
    """
    lib = _shim()
    if lib is None:
        raise RuntimeError("FFmpeg libraries not available")
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError("AAC-Encoder erwartet (frames, channels) Audiodaten")
    arr = np.ascontiguousarray(arr)
    err = ctypes.create_string_buffer(_ERRLEN)
    ret = lib.lavc_encode_aac(
        os.fspath(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.shape[0], arr.shape[1], int(rate), int(bitrate_kbps) * 1000,
        err, _ERRLEN,
    )
    if ret != 0:
        raise ValueError(err.value.decode("utf-8", "replace"))
