"""Build and load the CUDA kernel libraries (``csrc/*.cu``) with ``nvcc``.

Each source ``csrc/<name>.cu`` is compiled at first use for ``sm_90a`` into
its own shared library with a plain C interface,
``dextractor_tpu_torch/_build/libdxt_<name>.so``; the compilers of all
sources run at once.  The libraries are loaded with ``ctypes``.  A library
is rebuilt when its source, or any ``csrc/*.cuh`` header, is newer than it.
Each compiler writes a private temp file that is then ``os.replace``d into
place, so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time
from types import SimpleNamespace

_OPS = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# every pointer and the stream are c_void_p: ctypes would otherwise pass a
# 32-bit int and cut the address
ARGTYPES = {
    "dxt_encode_plain": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _P, ctypes.c_uint, _P],
    "dxt_encode_run": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _P, ctypes.c_uint,
                       _P],
    "dxt_pack_tags": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _P, ctypes.c_uint, _P],
    "dxt_pack_words": [_P, _P, _P, _I, _LL, _P, ctypes.c_uint, _P],
    "dxt_lut_gather": [_I, _P, _P, _P],
    "dxt_decode_plain": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P,
                         _I, _LL, _P],
    "dxt_decode_run": [_P, _LL, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P,
                       _P, _I, _LL, _P],
    "dxt_expand_runs": [_P, _P, _LL, _I, _P, _LL, _P, _P, _I, _LL, _P],
    "dxt_pack2bit": [_P, _P, _P, _P, _P, _LL, _LL, _P],
    "dxt_unpack2bit": [_P, _P, _P, _P, _P, _LL, _LL, _P],
    "dxt_tag_route": [_P, _LL, _P, _P, _I, _LL, _I, _P],
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise OSError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def lib_path(src: str) -> str:
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"libdxt_{name}.so")


def _stale(src: str) -> bool:
    out = lib_path(src)
    deps = [src, *glob.glob(os.path.join(SRC_DIR, "*.cuh"))]
    return (not os.path.exists(out)
            or os.path.getmtime(out) < max(map(os.path.getmtime, deps)))


def build(force: bool = False) -> tuple[list[str], float, str]:
    """Compile every library that is missing or stale, all at once.

    Returns (library paths, wall seconds spent compiling, compiler output);
    the output holds ``ptxas``' register and shared-memory report per
    kernel."""
    srcs = sources()
    todo = [s for s in srcs if force or _stale(s)]
    if not todo:
        return [lib_path(s) for s in srcs], 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        tmp = f"{lib_path(src)}.{os.getpid()}.tmp"
        jobs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    outs, failed = [], []
    for src, tmp, proc in jobs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}): {out[-4000:]}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, lib_path(src))
    seconds = time.perf_counter() - t0
    if failed:
        raise OSError("nvcc failed: " + "\n".join(failed))
    return [lib_path(s) for s in srcs], seconds, "".join(outs)


def load_library() -> SimpleNamespace:
    """Build if needed, load every library, and declare each entry point's
    signature; returns the entry points as attributes."""
    paths, _, _ = build()
    libs = [ctypes.CDLL(p) for p in paths]
    entry = {}
    for name, argtypes in ARGTYPES.items():
        fn = next((getattr(lib, name) for lib in libs if hasattr(lib, name)), None)
        if fn is None:
            raise OSError(f"no kernel library exports {name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entry[name] = fn
    return SimpleNamespace(**entry)
