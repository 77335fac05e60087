"""Build-on-first-use of the CUDA kernels in ``csrc/*.cu`` (with the
device helpers they share in ``csrc/*.cuh``).

``nvcc`` compiles each source to an object, all of them at once (one
``nvcc`` process per source), and links the objects into one shared
library with a plain C interface (no PyTorch headers, so it builds in
seconds), inside a content-hashed directory under ``_build/``
(gitignored); ``ctypes`` loads it.  A lock keeps the engine's threads from
building twice; temporary output names plus an atomic rename keep
concurrent processes from loading a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libpjt_cuda.so"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build_dir() -> str:
    """``_build/<hash of the sources, the headers they include and the
    flags>``: an edit to a shared header is a new library too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
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


def nvcc_commands(output: str, nvcc: str = "nvcc",
                  tag: str = "") -> Tuple[List[List[str]], List[str]]:
    """``(compile commands, link command)``: one ``nvcc -c`` per source
    into an object beside ``output`` (``tag`` keeps concurrent builds
    apart), then ``nvcc -shared`` of the objects into ``output``."""
    out_dir = os.path.dirname(output)
    objects = [os.path.join(out_dir, os.path.basename(src)[:-3] + tag + ".o")
               for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for obj, src in zip(objects, sources())]
    return compiles, [nvcc, "-shared", "-o", output, *objects]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``nvcc.log`` beside it."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    tmp = lib_path + tag
    compiles, link = nvcc_commands(tmp, find_nvcc(), tag)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [(cmd[-1], proc.communicate()[0], proc.returncode)
            for cmd, proc in zip(compiles, procs)]
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("".join(f"== {src}\n{log}" for src, log, _ in logs))
    failed = [(src, log) for src, log, rc in logs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed on " + "; ".join(
            f"{os.path.basename(src)}:\n{log[-4000:]}" for src, log in failed))
    proc = subprocess.run(link, capture_output=True, text=True)
    for obj in link[4:]:                        # the objects
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (once per process and source hash) and load the kernels."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            decode = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int]
            i32, f32, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
            for fn, argtypes in (
                    (lib.pjt_cuda_decode_rgb, decode + [ptr]),
                    (lib.pjt_cuda_decode_ycbcr, decode + [ptr]),
                    (lib.pjt_cuda_decode_rgb_scaled,
                     decode + [i32, ctypes.c_int64, ptr]),
                    (lib.pjt_cuda_rgb_scaled_resident, [i32] * 6 + [ptr]),
                    (lib.pjt_cuda_memfloor, decode + [ptr]),
                    (lib.pjt_cuda_decode_rgb_truerez, decode + [ptr]),
                    (lib.pjt_cuda_decode_rgb_stacked, decode + [ptr]),
                    (lib.pjt_cuda_raster_epilogue,
                     [ptr, ctypes.c_int64] + [i32] * 8
                     + [ptr, ptr, ptr, i32, i32] + [f32] * 6 + [ptr, ptr]),
                    (lib.pjt_cuda_dequant_stage,
                     [ptr, i32, ptr, ptr, i32, ptr, ctypes.c_int64, i32,
                      ptr]),
                    (lib.pjt_cuda_idct_stage,
                     [ptr, ptr, ctypes.c_int64, ptr]),
                    (lib.pjt_cuda_color_stage,
                     [ptr, ptr, ctypes.c_int64, i32, i32, i32, ptr]),
                    (lib.pjt_cuda_mxu2pass,
                     [ptr, ptr, ptr, ctypes.c_int64, i32, f32, f32, ptr]),
                    (lib.pjt_cuda_mxu64,
                     [ptr, ptr, ptr, ctypes.c_int64, f32, ptr]),
                    (lib.pjt_cuda_vlc, [ptr] * 5),
                    (lib.pjt_cuda_vlc_exit_violations, [ptr]),
                    (lib.pjt_cuda_raster_rows,
                     [ptr, ctypes.c_int64] + [i32] * 5 + [ptr])):
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
