"""Native host-side helpers, built on demand with gcc.

The port's own copy of the five shims of ``dextractor_tpu/native/`` that
its paths need, from copies of their C sources in this directory:
``qv_encode.c`` (the host channel encoder, the byte oracle of the device
encode, plus ragged copies and the scan histograms), ``qv_decode.c`` (the
sequential entry walker: the host decoder, the lens walk that gives the
device decoder its entry boundaries, and the .quiva text assembler),
``twobit_host.c`` (the host 2-bit pack and wrapped-text unpack, the byte
oracle of the 2-bit device path, and the one-pass .fasta/.arrow line scan)
``dexta_index.c`` (the .dexta/.dexar entry walker) and ``hdf5_shim.c``
(the .bax.h5 reader's access to libhdf5, resolved at run time with
dlopen).  Each is compiled once into ``native/build/`` and loaded with
ctypes; a shim that cannot build, or libhdf5 that cannot load, raises
OSError.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_LINK = {"hdf5_shim": ["-ldl"]}      # libraries a shim links beyond libc


def _build_shim(name: str):
    src = os.path.join(_DIR, f"{name}.c")
    out = os.path.join(_BUILD, f"_{name}.so")
    os.makedirs(_BUILD, exist_ok=True)
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        # compile to a private temp then os.replace: concurrent builders
        # (parallel pytest workers) must never dlopen a half-written .so
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["gcc", "-O2", "-shared", "-fPIC", src, "-o", tmp, *_LINK.get(name, [])]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise OSError(f"building {name} failed: {r.stderr[:500]}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)


def _declare(lib, signatures):
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_DECODE = {
    "dxt_qv_walk": (_LL, [
        _P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
        _P, _P, _P, _P, _P, _P,
        _P, _I, _P, _P,
        _LL, _LL, _P, _P, _P, _P,
        _P, _LL]),
    "dxt_quiva_text": (_LL, [_P, _LL, _LL, _P, _P, _P, _P]),
}

_ENCODE = {
    "dxt_encode_plain": (_LL, [_P, _P, _LL, _P, _P, _I, _P, _LL, _P]),
    "dxt_encode_run": (_LL, [_P, _P, _LL, _P, _P, _I, _P, _P, _I, _P, _LL, _P]),
    "dxt_pack_tags": (_LL, [_P, _P, _P, _LL, _I, _P, _P, _LL, _P]),
    "dxt_ragged_copy": (None, [_P, _P, _P, _P, _LL]),
    "dxt_run_hist": (None, [_P, _P, _LL, _I, _P]),
    "dxt_gather_copy": (None, [_P, _P, _P, _P, _LL]),
    "dxt_region_merge": (None, [_P, _P, _P, _LL, _LL, _P, _P]),
    "dxt_qv_scan_hists": (None, [_P, _P, _P, _P, _P, _LL, _P, _P]),
}

_TWOBIT = {
    "dxt_pack_seq": (_LL, [_P, _P, _LL, _P, _P, _LL, _P]),
    "dxt_unpack_text": (_LL, [_P, _P, _P, _LL, _LL, _P, _P, _P]),
    "dxt_line_stats": (None, [_P, _LL, _I, _P, _P]),
    "dxt_seq_scan": (_LL, [_P, _LL, _I, _P, _P, _P, _P]),
}

_DEXTA = {
    "dxt_dexta_walk": (_LL, [_P, _LL, _LL, _I, _LL, _P, _P, _P, _P, _P, _P, _P]),
}

_CS = ctypes.c_char_p
_PLL = ctypes.POINTER(ctypes.c_longlong)
_HDF5 = {
    "dxt_h5_init": (_I, [_CS]),
    "dxt_h5_open": (_LL, [_CS]),
    "dxt_h5_close": (None, [_LL]),
    "dxt_h5_dataset_dims": (_I, [_LL, _CS, _PLL, _I]),
    "dxt_h5_read": (_I, [_LL, _CS, _I, _P]),
    "dxt_h5_attr_str": (_I, [_LL, _CS, _CS, _CS, _I]),
    "dxt_h5_create": (_LL, [_CS]),
    "dxt_h5_write": (_I, [_LL, _CS, _I, _P, _PLL, _I]),
    "dxt_h5_attr_str_write": (_I, [_LL, _CS, _CS, _CS]),
}

_LIBS: dict = {}


def _shim(name: str, signatures):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = _declare(_build_shim(name), signatures)
    return lib


def qv_decode_shim():
    """The sequential .dexqv walker and text assembler (raises OSError
    when it cannot build)."""
    return _shim("qv_decode", _DECODE)


def qv_encode_shim():
    """The host-side channel encoder and ragged copies (raises OSError
    when it cannot build)."""
    return _shim("qv_encode", _ENCODE)


def twobit_host_shim():
    """Host 2-bit pack, wrapped-text unpack and sequence-file line scan
    (raises OSError when it cannot build)."""
    return _shim("twobit_host", _TWOBIT)


def dexta_index_shim():
    """The .dexta/.dexar entry walker (raises OSError when it cannot
    build)."""
    return _shim("dexta_index", _DEXTA)



def hdf5_shim():
    """The HDF5 dlopen shim with libhdf5 loaded (raises OSError when the
    shim cannot build or libhdf5 cannot load)."""
    lib = _LIBS.get("hdf5_shim")
    if lib is None:
        lib = _declare(_build_shim("hdf5_shim"), _HDF5)
        if lib.dxt_h5_init(b"") != 0:
            raise OSError("libhdf5 could not be initialized")
        _LIBS["hdf5_shim"] = lib
    return lib
