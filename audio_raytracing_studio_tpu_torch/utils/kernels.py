"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher (``extern "C"``), so it
compiles with nvcc alone — no PyTorch headers, seconds per file — into
``_build/lib<name>_<sha>.so`` at first use, named by a hash of the source and
the flags so an edited source never loads a stale library.  The library is
loaded with ctypes; callers declare ``argtypes`` and ``restype``.

No prebuilt library is shipped: a machine without nvcc cannot build, and
``build`` then raises.  Nothing falls back to a plain path.

``build_host`` does the same for the host libraries of the codecs: each
``utils/_native/<name>.cc`` compiles with g++ into the same ``_build/``, at
first use and never at import.  A failed host build is remembered beside its
target (``lib<name>_<sha>.failed``, same hash), so a library that cannot
build on this machine — the FFmpeg shim without FFmpeg's headers — costs
one g++ run per checkout, not one per process; a host library has a NumPy
or next-tier fallback, a kernel has none, so a failed nvcc build is not
remembered.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
HOST_SRC_DIR = PACKAGE_DIR / "utils" / "_native"
BUILD_DIR = PACKAGE_DIR / "_build"

# Hopper only (sm_90a).  No --use_fast_math: expf/powf must stay accurate.
# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch version computes them, so kernel and plain agree to the last bits
# of each sample rather than to an FMA's rounding.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def find_nvcc() -> str:
    """nvcc on PATH, else under PyTorch's CUDA_HOME; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under torch.utils.cpp_extension.CUDA_HOME; "
        "the CUDA kernels of this package are built from csrc/ at first use"
    )


_locks: dict = {}
_locks_guard = threading.Lock()


def _lock(source: Path) -> threading.Lock:
    """One lock per source file: different libraries build in parallel."""
    with _locks_guard:
        return _locks.setdefault(source, threading.Lock())


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) → path of the .so.
    Threads that reach a first use together build once: the others wait and
    find the library."""
    with _lock(CSRC_DIR / f"{name}.cu"):
        return _build(name)


def _build(name: str) -> Path:
    return _compile(CSRC_DIR / f"{name}.cu", name, find_nvcc, NVCC_FLAGS, ())


def build_host(name: str, link=()) -> Path:
    """Compile the host library ``utils/_native/<name>.cc`` with g++ (if not
    built yet), linked against ``link`` (e.g. ``("-lavcodec",)``) → path of
    the .so.  Same locking, naming and rename rule as ``build``; a failed
    build raises its compiler's message again, from its ``.failed`` marker,
    without running g++."""
    source = HOST_SRC_DIR / f"{name}.cc"
    with _lock(source):
        return _compile(source, name, lambda: "g++", CXX_FLAGS, tuple(link),
                        remember_failure=True)


def _replace_atomically(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _compile(source: Path, name: str, find_compiler, flags, link,
             remember_failure: bool = False) -> Path:
    """Library named by a hash of the source, the flags and the link line;
    the compiler is looked up only when the library is not built yet."""
    digest = hashlib.sha256(source.read_bytes() + " ".join([*flags, *link]).encode())
    target = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    failed = target.with_suffix(".failed")
    if remember_failure and failed.exists():
        raise RuntimeError(f"{failed.read_text()}\n(an earlier build failed; "
                           f"delete {failed} to build again)")
    compiler = find_compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build (another process included) never leaves a half-written library
    # under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", tmp, str(source), *link],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            message = (f"{os.path.basename(compiler)} failed to build {source.name} "
                       f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
            if remember_failure:
                _replace_atomically(failed, message)
            raise RuntimeError(message)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def load_host(name: str, link=()) -> ctypes.CDLL:
    """Build if needed and load ``utils/_native/<name>.cc`` with ctypes."""
    return ctypes.CDLL(str(build_host(name, link)))
