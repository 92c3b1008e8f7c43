"""Generic DB tracks and trailing extras (reference DB.c:1649-2312).

On-disk `.anno` layout: int32 tracklen, int32 size, then the annotation
payload, then zero or more "extras".  Three track shapes (DB.h:297-316):

- ``size > 0`` and no `.data` file: ``tracklen`` fixed-size anno records;
- ``size == 4``: anno is (tracklen+1) int32 offsets into `.data`;
- ``size == 8``: anno is (tracklen+1) int64 offsets into `.data`;
- ``size == 0`` in the header marks a mask track (int32 offsets + int
  interval pairs in `.data`).

Extras (DB.h:320-338, Read/Write_Extra DB.c:2130-2312): per item
int32 vtype (0=int64, 1=float64), int32 nelem, int32 accum (0=exact,
1=sum), int32 name length, name bytes, 8*nelem value bytes; folding
across block files either checks equality or sums.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.errors import DextractorError, FormatError

DB_INT = 0
DB_REAL = 1
DB_EXACT = 0
DB_SUM = 1

MASK_TRACK = 0
CUSTOM_TRACK = 1


@dataclass
class Extra:
    vtype: int
    accum: int
    name: bytes
    value: np.ndarray       # (nelem,) int64 or float64

    @property
    def nelem(self) -> int:
        return len(self.value)

    def fold(self, other: "Extra") -> None:
        """Reduce another block's value into this one (Read_Extra)."""
        if (other.vtype != self.vtype or other.nelem != self.nelem
                or other.accum != self.accum or other.name != self.name):
            raise FormatError(
                f"extra {other.name!r} does not agree with previous .anno block files")
        if self.accum == DB_EXACT:
            if not np.array_equal(self.value, other.value):
                raise FormatError(
                    f"Value of extra {other.name!r} does not agree with "
                    f"previous .anno block files")
        else:
            self.value = self.value + other.value


@dataclass
class Track:
    name: str
    size: int                       # anno record size (0 for mask tracks)
    nreads: int
    anno: np.ndarray                # offsets (size 4/8) or raw records
    data: np.ndarray | None = None  # variable-length payload (u8)
    extras: list = field(default_factory=list)

    @property
    def kind(self) -> int:
        return MASK_TRACK if self.size == 0 else CUSTOM_TRACK

    def read_data(self, i: int) -> np.ndarray:
        """data[anno[i] .. anno[i+1]) for read i."""
        if self.data is None:
            raise DextractorError(f"track {self.name} has no data part")
        return self.data[int(self.anno[i]): int(self.anno[i + 1])]

    def nbytes(self) -> int:
        s = int(self.anno.nbytes)
        if self.data is not None:
            s += int(self.data.nbytes)
        return s


def _parse_extras(buf: bytes, off: int) -> list[Extra]:
    out = []
    n = len(buf)
    while off + 16 <= n:
        vtype, nelem, accum, slen = struct.unpack_from("<iiii", buf, off)
        off += 16
        name = buf[off: off + slen]
        off += slen
        dtype = np.int64 if vtype == DB_INT else np.float64
        value = np.frombuffer(buf, dtype, count=nelem, offset=off).copy()
        off += 8 * nelem
        out.append(Extra(vtype, accum, name, value))
    return out


def extras_bytes(extras: list[Extra]) -> bytes:
    out = bytearray()
    for e in extras:
        out += struct.pack("<iiii", e.vtype, e.nelem, e.accum, len(e.name))
        out += e.name
        out += np.ascontiguousarray(e.value).tobytes()
    return bytes(out)


def track_paths(db_base: str, part: int, name: str):
    """Anno/data paths, preferring a block-part track (Check_Track)."""
    if part > 0:
        p = f"{db_base}.{part}.{name}"
        if os.path.exists(p + ".anno"):
            return p + ".anno", p + ".data", True
    p = f"{db_base}.{name}"
    return p + ".anno", p + ".data", False


def check_track(db, name: str):
    """Check_Track (DB.c:1649-1703): (-2 none, -3 junk via exception,
    -1 length mismatch, 0 untrimmed, 1 trimmed)."""
    apath, _, ispart = track_paths(db.path, db.part, name)
    if not os.path.exists(apath):
        return -2
    with open(apath, "rb") as f:
        hdr = f.read(8)
    if len(hdr) < 8:
        raise FormatError(f"track files for {name} are corrupted")
    tracklen, size = struct.unpack("<ii", hdr)
    if size < 0:
        raise FormatError(f"track files for {name} are corrupted")
    ureads = int(db.header["ureads"][0]) if not ispart else db.nreads
    treads = int(db.header["treads"][0]) if not ispart else db.nreads
    if tracklen == ureads:
        return 0
    if tracklen == treads:
        return 1
    return -1


def open_track(db, name: str) -> Track:
    """Open_Track + Load_All_Track_Data (DB.c:1714-2100, batched)."""
    apath, dpath, ispart = track_paths(db.path, db.part, name)
    if not os.path.exists(apath):
        raise DextractorError(f"no track {name}")
    with open(apath, "rb") as f:
        buf = f.read()
    tracklen, size = struct.unpack_from("<ii", buf, 0)
    has_data = os.path.exists(dpath)
    off = 8
    if has_data:
        esize = 8 if size == 8 else 4
        dtype = np.int64 if esize == 8 else np.int32
        anno = np.frombuffer(buf, dtype, count=tracklen + 1, offset=off).copy()
        off += esize * (tracklen + 1)
        with open(dpath, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8).copy()
    else:
        anno = np.frombuffer(buf, np.uint8,
                             count=tracklen * size, offset=off).copy()
        anno = anno.reshape(tracklen, size)
        off += tracklen * size
        data = None
    extras = _parse_extras(buf, off)

    # a track over the untrimmed DB opened on a trimmed one is trimmed late
    # (Late_Track_Trim, DB.c:1710-1790)
    if db.trimmed and tracklen != db.nreads:
        keep = _trim_mask(db, ispart, tracklen)
        if keep is not None:
            if data is not None:
                lens = np.diff(anno)[keep]
                parts = [data[anno[i]: anno[i + 1]]
                         for i in np.flatnonzero(keep)]
                data = (np.concatenate(parts) if parts
                        else np.empty(0, np.uint8))
                anno = np.zeros(int(keep.sum()) + 1, anno.dtype)
                np.cumsum(lens, out=anno[1:])
            else:
                anno = anno[keep]
            tracklen = int(keep.sum())

    return Track(name=name, size=size, nreads=tracklen, anno=anno,
                 data=data, extras=extras)


def _trim_mask(db, ispart, tracklen):
    from . import model
    with open(db.path + ".idx", "rb") as f:
        f.seek(model.DB_DTYPE.itemsize + model.READ_DTYPE.itemsize * db.ufirst)
        raw = f.read(model.READ_DTYPE.itemsize * tracklen)
    recs = np.frombuffer(raw, model.READ_DTYPE)
    if len(recs) != tracklen:
        return None
    allflag = 0 if (db.allarr & model.DB_ALL) else model.DB_BEST
    return ((recs["flags"] & model.DB_BEST) >= allflag) \
        & (recs["rlen"] >= db.cutoff)


def write_track(db_base: str, name: str, track: Track, part: int = 0) -> None:
    """Write .anno (+ .data) with trailing extras."""
    prefix = f"{db_base}.{part}.{name}" if part > 0 else f"{db_base}.{name}"
    with open(prefix + ".anno", "wb") as f:
        f.write(struct.pack("<ii", track.nreads, track.size))
        f.write(np.ascontiguousarray(track.anno).tobytes())
        f.write(extras_bytes(track.extras))
    if track.data is not None:
        with open(prefix + ".data", "wb") as f:
            f.write(np.ascontiguousarray(track.data).tobytes())
