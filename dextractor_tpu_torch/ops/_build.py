"""Build and load the CUDA kernel library (``csrc/*.cu``) with ``nvcc``.

The kernels are compiled at first use for ``sm_90a`` into a shared library
with a plain C interface, ``dextractor_tpu_torch/_build/libdxt_emit.so``, and
loaded with ``ctypes``.  The library is rebuilt when a source is newer than
it.  The compiler writes a private temp file that is then ``os.replace``d
into place, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_OPS = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdxt_emit.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# every pointer and the stream are c_void_p: ctypes would otherwise pass a
# 32-bit int and cut the address
ARGTYPES = {
    "dxt_encode_plain": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _P],
    "dxt_encode_run": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _P],
    "dxt_pack_tags": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _P],
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise OSError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def build(force: bool = False) -> tuple[str, float, str]:
    """Compile the library if it is missing or stale.

    Returns (library path, seconds spent compiling, compiler output); the
    output holds ``ptxas``' register and shared-memory report per kernel.
    """
    srcs = sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, srcs))):
        return LIB_PATH, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(s for s in srcs if s.endswith(".cu"))]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise OSError(f"nvcc failed ({r.returncode}): {r.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH, seconds, r.stdout + r.stderr


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
