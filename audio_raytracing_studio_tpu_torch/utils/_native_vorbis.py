"""ctypes binding of the Ogg/Vorbis hot loops (``_native/vorbis_core.cc``),
built by ``kernels.build_host`` at first use, never at import.
``available()`` is False where g++ cannot build it; ``vorbisio`` and
``vorbisenc`` then run their NumPy paths, which give the same bytes."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import kernels

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library; raises if it cannot be built."""
    lib = kernels.load_host("vorbis_core")
    lib.vorbis_pack_lsb.restype = ctypes.c_int64
    lib.vorbis_pack_lsb.argtypes = [_i32p, _u8p, ctypes.c_int64, _u8p]
    lib.vorbis_ogg_crc.restype = ctypes.c_uint32
    lib.vorbis_ogg_crc.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vorbis_vq_run.restype = ctypes.c_int64
    lib.vorbis_vq_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int32, _f32p, ctypes.c_int32, ctypes.c_int64, _f32p,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def available() -> bool:
    try:
        lib()
    except Exception:
        return False
    return True


class BookHandle:
    """Prepared ctypes pointers for one codebook (marshalling them on every
    call cost more than the decode loop itself)."""

    __slots__ = ("fast_ptr", "vec_ptr", "dims", "scratch", "scratch_ptr")

    def __init__(self, fast: np.ndarray, vectors: np.ndarray, max_count: int):
        self.fast_ptr = fast.ctypes.data_as(_i64p)
        self.vec_ptr = vectors.ctypes.data_as(_f32p)
        self.dims = int(vectors.shape[1])
        self.scratch = np.empty(max_count * self.dims, dtype=np.float32)
        self.scratch_ptr = self.scratch.ctypes.data_as(_f32p)


def vq_run(
    data: bytes, bitpos: int, handle: BookHandle, count: int,
    fast_bits: int = 10,
) -> int:
    """Decode `count` VQ entries into handle.scratch (count·dims float32).

    ``fast_bits`` is the width of the caller's fast lookup table and must
    equal ``vorbisio._FAST_BITS`` (the table builder): a mismatch indexes the
    wrong half of the table and decodes plausible but wrong entries instead
    of reporting a miss, so callers pass their constant explicitly.

    Returns the new absolute bit position, or -1 (fast-table miss or packet
    exhausted: the caller falls back to the Python path)."""
    return int(
        lib().vorbis_vq_run(
            data, len(data), bitpos,
            handle.fast_ptr, int(fast_bits),
            handle.vec_ptr, handle.dims, count,
            handle.scratch_ptr,
        )
    )


def pack_lsb(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """LSB-first pack: values[i]'s low nbits[i] bits, in order → bytes."""
    v = np.ascontiguousarray(values, dtype=np.int32)
    b = np.ascontiguousarray(nbits, dtype=np.uint8)
    total = int(b.sum(dtype=np.int64))
    out = np.zeros((total + 7) // 8, dtype=np.uint8)
    lib().vorbis_pack_lsb(
        v.ctypes.data_as(_i32p),
        b.ctypes.data_as(_u8p),
        len(v),
        out.ctypes.data_as(_u8p),
    )
    return out.tobytes()


def ogg_crc(data: bytes) -> int:
    return int(lib().vorbis_ogg_crc(data, len(data)))
