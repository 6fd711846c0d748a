"""ctypes binding of the FLAC hot loops (``_native/flac_core.cc``), built by
``kernels.build_host`` at first use, never at import.  ``available()`` is
False where g++ cannot build it; ``flacio`` then runs its NumPy / Python
paths, which give the same bytes."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import kernels

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library; raises if it cannot be built."""
    lib = kernels.load_host("flac_core")
    lib.flac_rice_decode.restype = ctypes.c_int64
    lib.flac_rice_decode.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, _i64p,
    ]
    lib.flac_rice_encode.restype = ctypes.c_int64
    lib.flac_rice_encode.argtypes = [_u64p, ctypes.c_int64, ctypes.c_int32, _u8p]
    lib.flac_lpc_reconstruct.restype = None
    lib.flac_lpc_reconstruct.argtypes = [
        _i64p, ctypes.c_int64, _i64p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.flac_crc8.restype = ctypes.c_uint32
    lib.flac_crc8.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.flac_crc16.restype = ctypes.c_uint32
    lib.flac_crc16.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    return lib


@functools.lru_cache(maxsize=None)
def available() -> bool:
    try:
        lib()
    except Exception:
        return False
    return True


def crc8(data: bytes) -> int:
    return int(lib().flac_crc8(data, len(data)))


def crc16(data: bytes) -> int:
    return int(lib().flac_crc16(data, len(data)))


def rice_decode(bits: np.ndarray, pos: int, k: int, n: int) -> tuple:
    """Decode n rice(k) values from the uint8 bit array → (values, new pos)."""
    out = np.empty(n, dtype=np.int64)
    new_pos = lib().flac_rice_decode(
        bits.ctypes.data_as(_u8p), bits.size, pos, k, n, out.ctypes.data_as(_i64p)
    )
    if new_pos < 0:
        raise EOFError("FLAC bitstream truncated in rice code")
    return out, int(new_pos)


def rice_encode(u: np.ndarray, k: int, total_bits: int) -> np.ndarray:
    """Encode zigzagged uint64 values as a rice(k) uint8 bit array."""
    bits = np.zeros(total_bits, dtype=np.uint8)
    u = np.ascontiguousarray(u, dtype=np.uint64)
    lib().flac_rice_encode(u.ctypes.data_as(_u64p), u.size, k, bits.ctypes.data_as(_u8p))
    return bits


def lpc_reconstruct(signal: np.ndarray, coeffs_oldest_first: np.ndarray,
                    shift: int) -> np.ndarray:
    """Integer LPC reconstruction (signal holds warmup + residual).

    Use the return value: input that is not contiguous int64 is copied and
    the copy is reconstructed; contiguous int64 input is reconstructed in
    place and returned as it is."""
    signal = np.ascontiguousarray(signal, dtype=np.int64)
    co = np.ascontiguousarray(coeffs_oldest_first, dtype=np.int64)
    lib().flac_lpc_reconstruct(
        signal.ctypes.data_as(_i64p), signal.size, co.ctypes.data_as(_i64p),
        co.size, shift,
    )
    return signal
