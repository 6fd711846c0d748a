"""ctypes binding of the FFmpeg-library shim (``_native/lavc_shim.cc``),
built by ``kernels.build_host`` at first use, never at import.

Unlike the other host libraries it links the system FFmpeg libraries
(libavformat / libavcodec 59, libavutil, libswresample), so the build fails
on a machine without their headers or shared objects: ``lavcio`` then
reports the tier unavailable and the callers go on to the next one.
"""

from __future__ import annotations

import ctypes
import functools

from . import kernels

LINK = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded shim; raises if it cannot be built or loaded."""
    lib = kernels.load_host("lavc_shim", LINK)
    c = ctypes
    f32pp = c.POINTER(c.POINTER(c.c_float))
    lib.lavc_decode_file.restype = c.c_int
    lib.lavc_decode_file.argtypes = [
        c.c_char_p, f32pp, c.POINTER(c.c_longlong),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.c_char_p, c.c_int,
    ]
    lib.lavc_free_buffer.restype = None
    lib.lavc_free_buffer.argtypes = [c.POINTER(c.c_float)]
    lib.lavc_probe_file.restype = c.c_int
    lib.lavc_probe_file.argtypes = [
        c.c_char_p, c.POINTER(c.c_longlong),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.c_char_p, c.c_int,
    ]
    lib.lavc_encode_aac.restype = c.c_int
    lib.lavc_encode_aac.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_longlong,
        c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int,
    ]
    return lib
