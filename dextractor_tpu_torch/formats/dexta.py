"""Byte-exact .dexta / .dexar container layer.

Stream layout (encoder loops dexta.c:102-205 / dexar.c:101-211, decoder
loops undexta.c:131-271 / undexar.c:129-229):

  uint16 0x55aa endian key
  int32  prefix length, prefix bytes (first header up to first '/', incl '>')
  per read:
    well delta bytes: one 0xff byte per 255 of delta, then a final byte
      holding the remainder (dexta.c:188-194)
    .dexta: int32 beg, int32 end, int32 qv
    .dexar: int32 beg, int32 end, 4 x uint16 round(snr*100) clamped at 9999
    ceil((end-beg)/4) bytes of 2-bit packed symbols (first symbol in bits 7-6)

The .dexta decoder additionally accepts the legacy 0x33cc key where
beg/end/qv are uint16 (undexta.c:140-159, 211-240); both keys decode
byte-flipped when written by an opposite-endian machine.

Writers are fully vectorized (single output buffer + ragged scatters);
readers walk entries with the native walker (native/dexta_index.c), or a
Python header scan for a byte-flipped file, and gather payloads in one
vectorized pass.  The port's own copy of ``dextractor_tpu/formats/dexta.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..utils.errors import FormatError
from .dexqv import _ragged_copier
from .ragged import Ragged, flat_gather_lens

KEY_NEW = 0x55AA
KEY_LEGACY = 0x33CC


def _well_delta_parts(wells: np.ndarray):
    """(n_ff, final_byte) arrays for the well-delta unary-ish encoding."""
    wells = wells.astype(np.int64)
    deltas = np.diff(wells, prepend=0)
    if (deltas < 0).any():
        raise FormatError("well numbers must be non-decreasing")
    n_ff = deltas // 255
    final = (deltas - 255 * n_ff).astype(np.uint8)
    return n_ff, final


def _assemble(prefix: bytes, field_bytes: np.ndarray, n_ff: np.ndarray,
              final: np.ndarray, payload: np.ndarray, clens: np.ndarray) -> bytes:
    """Vectorized assembly of the container image.

    field_bytes: (N, F) fixed-width little-endian field image per read.
    """
    n, fwidth = field_bytes.shape
    clens = clens.astype(np.int64)
    head = struct.pack("<HI", KEY_NEW, len(prefix)) + prefix
    # note: prefix length is int32; struct 'I' works for len < 2^31

    ent_lens = n_ff + 1 + fwidth + clens
    ent_off = np.zeros(n + 1, np.int64)
    np.cumsum(ent_lens, out=ent_off[1:])
    out = np.empty(int(ent_off[-1]), np.uint8)

    # 0xff escape bytes
    total_ff = int(n_ff.sum())
    if total_ff:
        f_starts = np.zeros(n, np.int64)
        np.cumsum(n_ff[:-1], out=f_starts[1:])
        pos = (np.arange(total_ff, dtype=np.int64) - np.repeat(f_starts, n_ff)
               + np.repeat(ent_off[:-1], n_ff))
        out[pos] = 0xFF
    # final well byte
    out[ent_off[:-1] + n_ff] = final
    # fixed fields
    fpos = (ent_off[:-1] + n_ff + 1)[:, None] + np.arange(fwidth, dtype=np.int64)[None, :]
    out[fpos] = field_bytes
    # payload: one memcpy per entry via the native shim (the NumPy
    # fancy-index scatter costs ~16 index bytes per payload byte)
    total_p = int(clens.sum())
    if total_p:
        dst_off = np.ascontiguousarray(ent_off[:-1] + n_ff + 1 + fwidth)
        flat = np.ascontiguousarray(payload[:total_p], np.uint8)
        copier = _ragged_copier()
        if copier is not None:
            import ctypes

            ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
            copier(ptr(out), ptr(dst_off), ptr(flat),
                   ptr(np.ascontiguousarray(clens)), n)
        else:
            p_starts = np.zeros(n, np.int64)
            np.cumsum(clens[:-1], out=p_starts[1:])
            pos = (np.arange(total_p, dtype=np.int64) - np.repeat(p_starts, clens)
                   + np.repeat(dst_off, clens))
            out[pos] = flat

    return head + out.tobytes()


def write_dexta(prefix: bytes, wells, begs, ends, qvs,
                payload: np.ndarray, clens: np.ndarray) -> bytes:
    n = len(wells)
    fields = np.empty((n, 12), np.uint8)
    fields[:, 0:4] = np.asarray(begs, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 4:8] = np.asarray(ends, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 8:12] = np.asarray(qvs, "<i4").reshape(n, 1).view(np.uint8)
    n_ff, final = _well_delta_parts(np.asarray(wells))
    return _assemble(prefix, fields, n_ff, final, payload, clens)


def write_dexar(prefix: bytes, wells, begs, ends, cnrs,
                payload: np.ndarray, clens: np.ndarray) -> bytes:
    n = len(wells)
    fields = np.empty((n, 16), np.uint8)
    fields[:, 0:4] = np.asarray(begs, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 4:8] = np.asarray(ends, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 8:16] = np.asarray(cnrs, "<u2").reshape(n, 4).view(np.uint8).reshape(n, 8)
    n_ff, final = _well_delta_parts(np.asarray(wells))
    return _assemble(prefix, fields, n_ff, final, payload, clens)


@dataclass
class DextaFile:
    prefix: bytes
    wells: np.ndarray
    begs: np.ndarray
    ends: np.ndarray
    qvs: np.ndarray | None       # .dexta
    cnrs: np.ndarray | None      # .dexar (N,4) uint16 snr*100
    payload: Ragged              # 2-bit packed bytes per read


def _read_key(mv: memoryview, arrow: bool):
    if len(mv) < 6:
        raise FormatError("truncated container (header)")
    (key,) = struct.unpack_from("<H", mv, 0)
    if key == KEY_NEW:
        return False, True
    if key == 0xAA55:
        return True, True
    if not arrow:
        if key == KEY_LEGACY:
            return False, False
        if key == 0xCC33:
            return True, False
    kind = ".dexar" if arrow else ".dexta"
    raise FormatError(f"Not a {kind} file, endian key invalid")


def _read_dexta_native(data: bytes, arrow: bool, newv: bool, off: int,
                       prefix: bytes) -> "DextaFile | None":
    """Entry walk via the native indexer (entry sizes chain sequentially)."""
    from ..native import dexta_index_shim

    try:
        lib = dexta_index_shim()
    except OSError:
        return None
    import ctypes

    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    mode = 1 if arrow else (0 if newv else 2)
    cap = max(size // (14 if newv else 7) + 2, 16)
    wells = np.zeros(cap, np.int32)
    begs = np.zeros(cap, np.int32)
    ends_ = np.zeros(cap, np.int32)
    qvs = np.zeros(cap, np.int32)
    cnrs = np.zeros(4 * cap, np.uint16)
    poffs = np.zeros(cap, np.int64)
    plens = np.zeros(cap, np.int64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    ne = lib.dxt_dexta_walk(ptr(buf), size, off, mode, cap,
                            ptr(wells), ptr(begs), ptr(ends_), ptr(qvs),
                            ptr(cnrs), ptr(poffs), ptr(plens))
    if ne < 0:
        raise FormatError("truncated container (payload)")
    ne = int(ne)
    flat = flat_gather_lens(buf, poffs[:ne], plens[:ne])
    return DextaFile(
        prefix=prefix, wells=wells[:ne], begs=begs[:ne], ends=ends_[:ne],
        qvs=None if arrow else qvs[:ne],
        cnrs=cnrs.reshape(cap, 4)[:ne] if arrow else None,
        payload=Ragged(flat, plens[:ne]))


def read_dexta(data: bytes, arrow: bool = False) -> DextaFile:
    """Parse a .dexta (arrow=False) or .dexar (arrow=True) image."""
    mv = memoryview(data)
    flip, newv = _read_key(mv, arrow)
    end = "<" if not flip else ">"
    (plen,) = struct.unpack_from(end + "i", mv, 2)
    if plen < 0 or 6 + plen > len(mv):
        raise FormatError("truncated container (prefix)")
    prefix = bytes(mv[6:6 + plen])
    off = 6 + plen

    if not flip:
        fast = _read_dexta_native(data, arrow, newv, off, prefix)
        if fast is not None:
            return fast

    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    wells, begs, ends_, qvs, cnrs, starts, clens = [], [], [], [], [], [], []
    if arrow:
        fmt = struct.Struct(end + "ii4H")
    elif newv:
        fmt = struct.Struct(end + "iii")
    else:
        fmt = struct.Struct(end + "3H")
    fsize = fmt.size

    well = 0
    while off < size:
        b = buf[off]
        off += 1
        while b == 255:
            well += 255
            if off >= size:
                raise FormatError("truncated container (well escape)")
            b = buf[off]
            off += 1
        well += int(b)
        if off + fsize > size:
            raise FormatError("truncated container (fields)")
        f = fmt.unpack_from(mv, off)
        off += fsize
        beg, endp = f[0], f[1]
        clen = (endp - beg + 3) >> 2
        if off + clen > size:
            raise FormatError("truncated container (payload)")
        wells.append(well)
        begs.append(beg)
        ends_.append(endp)
        if arrow:
            cnrs.append(f[2:6])
        else:
            qvs.append(f[2])
        starts.append(off)
        clens.append(clen)
        off += clen

    starts = np.array(starts, np.int64)
    clens_a = np.array(clens, np.int64)
    flat = flat_gather_lens(buf, starts, clens_a)
    return DextaFile(
        prefix=prefix,
        wells=np.array(wells, np.int32),
        begs=np.array(begs, np.int32),
        ends=np.array(ends_, np.int32),
        qvs=None if arrow else np.array(qvs, np.int32),
        cnrs=np.array(cnrs, np.uint16) if arrow else None,
        payload=Ragged(flat, clens_a),
    )
