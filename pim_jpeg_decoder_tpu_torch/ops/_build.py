"""Build-on-first-use of the CUDA kernels in ``csrc/*.cu``.

``nvcc`` compiles the sources into a shared library with a plain C
interface (no PyTorch headers, so it builds in seconds), inside a
content-hashed directory under ``_build/`` (gitignored), and ``ctypes``
loads it.  A lock keeps the engine's threads from building twice; a
temporary output name plus an atomic rename keeps concurrent processes
from loading a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libpjt_cuda.so"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_dir() -> str:
    """``_build/<hash of the sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def nvcc_command(output: str, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", output, *sources()]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``nvcc.log`` beside it."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run(nvcc_command(tmp, find_nvcc()),
                          capture_output=True, text=True)
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (once per process and source hash) and load the kernels."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn in (lib.pjt_cuda_decode_rgb, lib.pjt_cuda_decode_ycbcr):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
