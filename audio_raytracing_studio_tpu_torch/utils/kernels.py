"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher (``extern "C"``), so it
compiles with nvcc alone — no PyTorch headers, seconds per file — into
``_build/lib<name>_<sha>.so`` at first use, named by a hash of the source and
the flags so an edited source never loads a stale library.  The library is
loaded with ctypes; callers declare ``argtypes`` and ``restype``.

No prebuilt library is shipped: a machine without nvcc cannot build, and
``build`` then raises.  Nothing falls back to a plain path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) → path of the .so."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name)))
