"""ctypes binding of the PCM16 codec (``_native/pcm_codec.cc``), built by
``kernels.build_host`` at first use, never at import.  ``available()`` is
False where g++ cannot build it; ``wavio`` then converts with NumPy, to the
same bits."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import kernels


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library; raises if it cannot be built."""
    lib = kernels.load_host("pcm_codec")
    lib.encode_pcm16.restype = None
    lib.encode_pcm16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
    ]
    lib.decode_pcm16.restype = None
    lib.decode_pcm16.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def available() -> bool:
    try:
        lib()
    except Exception:
        return False
    return True


def encode_pcm16(x: np.ndarray) -> np.ndarray:
    """float32 array → int16 with libsndfile semantics (shape preserved)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.int16)
    lib().encode_pcm16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        x.size,
    )
    return out


def decode_pcm16(raw: np.ndarray) -> np.ndarray:
    """int16 array → float32, ÷32768 (shape preserved)."""
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    out = np.empty(raw.shape, dtype=np.float32)
    lib().decode_pcm16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size,
    )
    return out
