"""Byte-exact .dexqv container layer (``dextractor_tpu/formats/dexqv.py``).

Layout (dexqv.c:104-143, QV.c:1173-1320, undexqv.c:101-208):

  uint16 0x55aa container key          (legacy files omit it; the decoder
                                        rewinds when absent, undexqv.c:103-110)
  QVcoding:
    uint16 0x33cc codec key
    uint16 delChar (256 => none), uint16 subChar (256 => none)
    int32 prefix length + prefix bytes (includes the '@')
    Huffman schemes in order: del, [dRun if delChar>=0], ins, mrg, sub,
    [sRun if subChar>=0] — each: type byte + 256 x (len byte [+ u32 code])
  per entry:
    well-delta bytes, int32 beg, int32 end, int32 qv
    bitstreams: delQV (plain|RLE), 2-bit packed delTag, insQV, mrgQV,
    subQV (plain|RLE)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..native import qv_encode_shim
from ..ops.huffman import HScheme, parse_scheme, scheme_bytes
from ..utils.errors import FormatError

CODEC_KEY = 0x33CC
CONTAINER_KEY = 0x55AA


@dataclass
class QVCoding:
    del_scheme: HScheme
    ins_scheme: HScheme
    mrg_scheme: HScheme
    sub_scheme: HScheme
    drun_scheme: HScheme | None
    srun_scheme: HScheme | None
    del_char: int            # -1 if none
    sub_char: int            # -1 if none
    prefix: bytes
    flip: bool = False       # written on a big-endian host (parse side only)


def coding_from_reference(c) -> QVCoding:
    """The JAX package's ``QVCoding`` (numpy tables) as the port's, so that
    both sides can encode with the same tables."""
    def scheme(s):
        if s is None:
            return None
        return HScheme(int(s.type), np.asarray(s.codelens, np.int32).copy(),
                       np.asarray(s.codebits, np.uint32).copy())

    return QVCoding(scheme(c.del_scheme), scheme(c.ins_scheme),
                    scheme(c.mrg_scheme), scheme(c.sub_scheme),
                    scheme(c.drun_scheme), scheme(c.srun_scheme),
                    int(c.del_char), int(c.sub_char), bytes(c.prefix),
                    bool(getattr(c, "flip", False)))


def qvcoding_bytes(c: QVCoding) -> bytes:
    out = bytearray()
    out += struct.pack("<H", CODEC_KEY)
    out += struct.pack("<H", 256 if c.del_char < 0 else c.del_char)
    out += struct.pack("<H", 256 if c.sub_char < 0 else c.sub_char)
    out += struct.pack("<i", len(c.prefix))
    out += c.prefix
    out += scheme_bytes(c.del_scheme)
    if c.del_char >= 0:
        out += scheme_bytes(c.drun_scheme)
    out += scheme_bytes(c.ins_scheme)
    out += scheme_bytes(c.mrg_scheme)
    out += scheme_bytes(c.sub_scheme)
    if c.sub_char >= 0:
        out += scheme_bytes(c.srun_scheme)
    return bytes(out)


def parse_qvcoding(mv: memoryview, off: int) -> tuple[QVCoding, int]:
    """Read_QVcoding (QV.c:1243-1320): the coding at ``off`` and the offset
    past it.  A codec key other than 0x33cc means the file was written on a
    host of the other byte order: its fields are read big-endian."""
    if off + 2 > len(mv):
        raise FormatError("could not read flip byte (QVcoding)")
    (key,) = struct.unpack_from("<H", mv, off)
    flip = key != CODEC_KEY
    off += 2
    end = ">" if flip else "<"
    if off + 8 > len(mv):
        raise FormatError("could not read the QVcoding header")
    dc, sc, plen = struct.unpack_from(end + "HHi", mv, off)
    off += 8
    if plen < 0 or off + plen > len(mv):
        raise FormatError("could not read header name (QVcoding)")
    prefix = bytes(mv[off:off + plen])
    off += plen

    del_char = -1 if dc >= 256 else dc
    sub_char = -1 if sc >= 256 else sc
    del_s, off = parse_scheme(mv, off, flip)
    drun = None
    if del_char >= 0:
        drun, off = parse_scheme(mv, off, flip)
    ins_s, off = parse_scheme(mv, off, flip)
    mrg_s, off = parse_scheme(mv, off, flip)
    sub_s, off = parse_scheme(mv, off, flip)
    srun = None
    if sub_char >= 0:
        srun, off = parse_scheme(mv, off, flip)
    return QVCoding(del_s, ins_s, mrg_s, sub_s, drun, srun,
                    del_char, sub_char, prefix, flip), off


def _ragged_copier():
    """Native per-entry memcpy (dxt_ragged_copy), or None to use the
    NumPy fancy-index fallback."""
    try:
        return qv_encode_shim().dxt_ragged_copy
    except OSError:
        return None


def assemble_dexqv(coding: QVCoding, wells, begs, ends, qvs,
                   parts: list[tuple[np.ndarray, np.ndarray]]) -> bytes:
    """Vectorized container assembly from per-entry payload parts.

    ``parts`` is an ordered list of (flat u8 array, per-entry byte lengths)
    — del words, packed tag, ins words, mrg words, sub words.  One ragged
    scatter per part builds the image; no per-entry Python loop.
    """
    head = struct.pack("<H", CONTAINER_KEY) + qvcoding_bytes(coding)

    wells = np.asarray(wells, np.int64)
    n = len(wells)
    deltas = np.diff(wells, prepend=0)
    if (deltas < 0).any():
        raise FormatError("well numbers must be non-decreasing")
    n_ff = deltas // 255
    final = (deltas - 255 * n_ff).astype(np.uint8)

    part_lens = [np.asarray(l, np.int64) for _, l in parts]
    hdr_lens = n_ff + 13
    ent_lens = hdr_lens + sum(part_lens)
    ent_off = np.zeros(n + 1, np.int64)
    np.cumsum(ent_lens, out=ent_off[1:])
    out = np.empty(int(ent_off[-1]), np.uint8)

    total_ff = int(n_ff.sum())
    if total_ff:
        f_starts = np.zeros(n, np.int64)
        np.cumsum(n_ff[:-1], out=f_starts[1:])
        pos = (np.arange(total_ff, dtype=np.int64) - np.repeat(f_starts, n_ff)
               + np.repeat(ent_off[:-1], n_ff))
        out[pos] = 0xFF
    out[ent_off[:-1] + n_ff] = final
    fields = np.empty((n, 12), np.uint8)
    fields[:, 0:4] = np.asarray(begs, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 4:8] = np.asarray(ends, "<i4").reshape(n, 1).view(np.uint8)
    fields[:, 8:12] = np.asarray(qvs, "<i4").reshape(n, 1).view(np.uint8)
    fpos = (ent_off[:-1] + n_ff + 1)[:, None] + np.arange(12, dtype=np.int64)[None, :]
    out[fpos] = fields

    base = ent_off[:-1] + hdr_lens
    copier = _ragged_copier()                       # one memcpy per entry
    for k, (flat, lens) in enumerate(parts):
        lens = part_lens[k]
        total = int(lens.sum())
        if total:
            flat = np.ascontiguousarray(np.asarray(flat, np.uint8)[:total])
            if copier is not None:
                dst = np.ascontiguousarray(base)
                lens_c = np.ascontiguousarray(lens)
                copier(out.ctypes.data, dst.ctypes.data, flat.ctypes.data,
                       lens_c.ctypes.data, n)
            else:
                p_starts = np.zeros(n, np.int64)
                np.cumsum(lens[:-1], out=p_starts[1:])
                pos = (np.arange(total, dtype=np.int64)
                       - np.repeat(p_starts, lens) + np.repeat(base, lens))
                out[pos] = flat
        base = base + lens
    return head + out.tobytes()


def write_dexqv(coding: QVCoding, wells, begs, ends, qvs,
                entry_blobs: list[bytes]) -> bytes:
    """Assemble the .dexqv image (container key + coding + framed entries)
    from whole per-entry payloads, entry by entry: the framing of the
    per-entry encoder (codecs/qv_codec.encode_entry)."""
    out = bytearray(struct.pack("<H", CONTAINER_KEY))
    out += qvcoding_bytes(coding)
    lwell = 0
    for w, b, e, q, blob in zip(np.asarray(wells).tolist(), np.asarray(begs).tolist(),
                                np.asarray(ends).tolist(), np.asarray(qvs).tolist(),
                                entry_blobs):
        d = w - lwell
        while d >= 255:
            out.append(0xFF)
            d -= 255
        out.append(d)
        lwell = w
        out += struct.pack("<iii", b, e, q)
        out += blob
    return bytes(out)
