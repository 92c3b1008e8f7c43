"""Vectorized .quiva text parsing/writing.

A .quiva entry is a '@' header line followed by exactly five equal-length
lines: delQV, delTag, insQV, mergeQV, subQV (reference Read_Lines QV.c:751-798,
QVcoding_Scan QV.c:922-1023).  Header grammar matches .fasta's
(``@prefix/well/beg_end RQ=0.qv`` — all four fields required, QV.c:964).

The port's own copy of ``dextractor_tpu/formats/quiva.py`` (with the two
helpers it took from ``formats/fasta.py``), on the port's native shims.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass

import numpy as np

from ..native import qv_decode_shim, qv_encode_shim
from ..utils.errors import FormatError

_NUM = rb"[-+]?\d+"


def _split_lines(data: bytes):
    """(buffer, line starts, line ends) of a newline-terminated text image
    (``dextractor_tpu/formats/fasta.py::_split_lines``)."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size == 0:
        raise FormatError("empty sequence file")
    if buf[-1] != 10:
        raise FormatError("last line does not end with a newline")
    ends = np.flatnonzero(buf == 10)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    return buf, starts, ends


_QUIVA_HDR = re.compile(
    rb"(" + _NUM + rb")/(" + _NUM + rb")_(" + _NUM + rb")\s*RQ=0\.\s*(" + _NUM + rb")"
)


@dataclass
class QuivaFile:
    prefix: bytes              # first header up to first '/', including '@'
    wells: np.ndarray
    begs: np.ndarray
    ends: np.ndarray
    qvs: np.ndarray
    lengths: np.ndarray        # (N,) per-entry stream length
    streams: np.ndarray        # (5, total) u8: del, tag, ins, mrg, sub

    @property
    def n_entries(self) -> int:
        return len(self.lengths)


def parse_quiva(data: bytes) -> QuivaFile:
    buf, starts, ends = _split_lines(data)
    n_lines = len(starts)
    if n_lines % 6 != 0:
        raise FormatError("incomplete last entry of .quiv file")
    n = n_lines // 6
    hdr_starts = starts[0::6]
    if (buf[hdr_starts] != ord("@")).any():
        raise FormatError("header in quiva file is missing")

    line_lens = ends - starts
    lens6 = line_lens.reshape(n, 6)
    lengths = lens6[:, 1].astype(np.int64)
    if not (lens6[:, 1:] == lengths[:, None]).all():
        raise FormatError("lines for an entry are not the same length")

    total = int(lengths.sum())
    streams = np.empty((5, total), np.uint8)
    starts6 = starts.reshape(n, 6)
    if total:
        try:                      # one memcpy per line through the shim
            lib = qv_encode_shim()
        except OSError:           # else one index gather per stream
            lib = None
        if lib is not None:
            lens_c = np.ascontiguousarray(lengths)
            for s in range(5):
                src = np.ascontiguousarray(starts6[:, s + 1].astype(np.int64))
                lib.dxt_gather_copy(_ptr(streams[s]), _ptr(buf), _ptr(src), _ptr(lens_c), n)
        else:
            run_starts = np.zeros(n, np.int64)
            np.cumsum(lengths[:-1], out=run_starts[1:])
            rel = np.arange(total, dtype=np.int64) - np.repeat(run_starts, lengths)
            for s in range(5):
                streams[s] = buf[np.repeat(starts6[:, s + 1], lengths) + rel]

    wells = np.zeros(n, np.int32)
    begs = np.zeros(n, np.int32)
    endf = np.zeros(n, np.int32)
    qvs = np.zeros(n, np.int32)
    prefix = b""
    mv = memoryview(data)
    for i, (hs, he) in enumerate(zip(hdr_starts, ends[0::6])):
        line = bytes(mv[hs:he])
        slash = line.find(b"/", 1)
        if slash < 0:
            raise FormatError("header line incorrectly formatted ?")
        if i == 0:
            prefix = line[:slash]
        m = _QUIVA_HDR.match(line, slash + 1)
        if m is None:
            raise FormatError("header line incorrectly formatted ?")
        wells[i] = int(m.group(1))
        begs[i] = int(m.group(2))
        endf[i] = int(m.group(3))
        qvs[i] = int(m.group(4))

    return QuivaFile(prefix, wells, begs, endf, qvs, lengths, streams)


def write_quiva(prefix: bytes, wells, begs, ends, qvs, lengths: np.ndarray,
                streams: np.ndarray) -> bytes:
    """Assemble a .quiva image from decoded streams (undexqv.c:182-207):
    the native text assembler copies each entry's header and five lines;
    without the shim, one NumPy scatter per part."""
    n = len(wells)
    if n == 0:
        return b""
    lengths = np.ascontiguousarray(lengths, np.int64)
    if streams.strides[1] != 1:
        streams = np.ascontiguousarray(streams)
    headers = [prefix + f"/{w}/{b}_{e} RQ=0.{q}".encode()
               for w, b, e, q in zip(np.asarray(wells).tolist(), np.asarray(begs).tolist(),
                                     np.asarray(ends).tolist(), np.asarray(qvs).tolist())]
    hdr_lens = np.array([len(h) for h in headers], np.int64)
    headers = b"".join(headers)
    try:
        lib = qv_decode_shim()
    except OSError:
        return _quiva_text_np(headers, hdr_lens, lengths, streams)
    out = np.empty(len(headers) + n + 5 * int(lengths.sum()) + 5 * n, np.uint8)
    nw = lib.dxt_quiva_text(
        _ptr(streams), streams.strides[0], n, _ptr(lengths),
        _ptr(np.frombuffer(headers, np.uint8)), _ptr(hdr_lens), _ptr(out))
    return out[:nw].tobytes()


def _quiva_text_np(headers: bytes, hdr_lens, lengths, streams) -> bytes:
    """The .quiva text of ``write_quiva`` by NumPy scatters: each entry is
    its header, then five lines of its streams, each ended by a newline."""
    n = len(lengths)
    blk_lens = hdr_lens + 1 + 5 * (lengths + 1)
    blk_off = np.zeros(n + 1, np.int64)
    np.cumsum(blk_lens, out=blk_off[1:])
    out = np.full(int(blk_off[-1]), ord("\n"), np.uint8)
    total_h = int(hdr_lens.sum())
    if total_h:
        h_starts = np.zeros(n, np.int64)
        np.cumsum(hdr_lens[:-1], out=h_starts[1:])
        pos = (np.arange(total_h, dtype=np.int64) - np.repeat(h_starts, hdr_lens)
               + np.repeat(blk_off[:-1], hdr_lens))
        out[pos] = np.frombuffer(headers, np.uint8)
    total = int(lengths.sum())
    if total:
        run_starts = np.zeros(n, np.int64)
        np.cumsum(lengths[:-1], out=run_starts[1:])
        rel = np.arange(total, dtype=np.int64) - np.repeat(run_starts, lengths)
        base = blk_off[:-1] + hdr_lens + 1
        for s in range(5):
            line_base = np.repeat(base + s * (lengths + 1), lengths)
            out[line_base + rel] = streams[s]
    return out.tobytes()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)
