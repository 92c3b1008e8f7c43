"""Dazzler DB on-disk binary layouts.

The reference dumps its in-core C structs raw into the .idx file
(dex2DB.c:287, 1001-1002), so the byte layout is the x86-64 struct ABI of
DAZZ_READ / DAZZ_DB (DB.h:285-295, 390-420) — including alignment padding
and (meaningless on disk) pointer fields.  NumPy structured dtypes replicate
that layout exactly; pointers and padding are written as zeros and ignored
on read.

Flags word: low 10 bits = read quality (DB_QV), plus DB_CCS / DB_BEST
(DB.h:276-278).  The reference's default build defines HIDE_FILES (DB.h:22)
so PATHSEP is "/." and all binary DB files are hidden dot-files
(DB.c:25-29); plain-named DBs (a non-HIDE_FILES build) are accepted on read.
"""

from __future__ import annotations

import numpy as np

DB_QV = 0x03FF
DB_CCS = 0x0400
DB_BEST = 0x0800

DB_ARROW = 0x2
DB_ALL = 0x1

MAX_NAME = 10000

# DAZZ_READ: int origin, rlen, fpulse; int64 boff, coff; int flags  (40 B)
READ_DTYPE = np.dtype([
    ("origin", "<i4"), ("rlen", "<i4"), ("fpulse", "<i4"), ("_pad0", "<i4"),
    ("boff", "<i8"), ("coff", "<i8"), ("flags", "<i4"), ("_pad1", "<i4"),
])
assert READ_DTYPE.itemsize == 40

# DAZZ_DB header struct (112 B incl. pointer fields)
DB_DTYPE = np.dtype([
    ("ureads", "<i4"), ("treads", "<i4"), ("cutoff", "<i4"), ("allarr", "<i4"),
    ("freq", "<f4", (4,)), ("maxlen", "<i4"), ("_pad0", "<i4"),
    ("totlen", "<i8"),
    ("nreads", "<i4"), ("trimmed", "<i4"), ("part", "<i4"),
    ("ufirst", "<i4"), ("tfirst", "<i4"), ("_pad1", "<i4"),
    ("_path_ptr", "<i8"), ("loaded", "<i4"), ("_pad2", "<i4"),
    ("_bases_ptr", "<i8"), ("_reads_ptr", "<i8"), ("_tracks_ptr", "<i8"),
])
assert DB_DTYPE.itemsize == 112


def new_db_header() -> np.ndarray:
    return np.zeros(1, DB_DTYPE)


def pack_snr_coff(cnr: np.ndarray) -> np.ndarray:
    """Pack 4 uint16 snr*100 values into the int64 coff field
    (cnr[0]<<48 | cnr[1]<<32 | cnr[2]<<16 | cnr[3], dex2DB.c:638-641)."""
    c = cnr.astype(np.uint64)
    return ((c[..., 0] << 48) | (c[..., 1] << 32)
            | (c[..., 2] << 16) | c[..., 3]).astype(np.int64)


def unpack_snr_coff(coff: np.ndarray) -> np.ndarray:
    c = coff.astype(np.int64).view(np.uint64)
    out = np.empty(coff.shape + (4,), np.uint16)
    out[..., 0] = (c >> np.uint64(48)) & np.uint64(0xFFFF)
    out[..., 1] = (c >> np.uint64(32)) & np.uint64(0xFFFF)
    out[..., 2] = (c >> np.uint64(16)) & np.uint64(0xFFFF)
    out[..., 3] = c & np.uint64(0xFFFF)
    return out
