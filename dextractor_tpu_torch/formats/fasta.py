"""Vectorized .fasta / .arrow text parsing and writing (host control plane).

The reference streams these files line-by-line with fgets/sscanf
(dexta.c:102-205, dexar.c:101-211, undexta.c:175-271, undexar.c:158-229).
Here whole files are parsed with one native line scan (or NumPy newline
scans) and assembled with ragged copies, so the host side keeps up with the
device codec kernels.  The port's own copy of
``dextractor_tpu/formats/fasta.py``; its ``write_seq_file`` takes the
symbols flat, as the device unpack returns them, not as a padded rectangle.

Header grammar (after the first '/'): ``well/beg_end RQ=0.qv`` for fasta
(qv optional, defaults 0 — dexta.c:151-157) and ``well/beg_end SN=a,b,c,d``
for arrow (all fields required — dexar.c:152-157).  The stored prefix is the
first header up to (not including) the first '/', and *includes* the leading
'>' (dexta.c:118-129).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..utils.errors import FormatError
from .ragged import Ragged

_NUM = rb"[-+]?\d+"
_FLT = rb"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"

_FASTA_HDR = re.compile(
    rb"(" + _NUM + rb")/(" + _NUM + rb")_(" + _NUM + rb")"
    rb"(?:\s*RQ=0\.\s*(" + _NUM + rb"))?"
)
_ARROW_HDR = re.compile(
    rb"(" + _NUM + rb")/(" + _NUM + rb")_(" + _NUM + rb")"
    rb"\s*SN=\s*(" + _FLT + rb"),\s*(" + _FLT + rb"),\s*(" + _FLT + rb"),\s*(" + _FLT + rb")"
)

# line-anchored variants for the bulk findall over joined header lines;
# [^/\n]*? reproduces the per-line "first '/'" split of the loop parser
_FASTA_HDR_LINE = re.compile(rb"(?m)^[^/\n]*?/" + _FASTA_HDR.pattern)
_ARROW_HDR_LINE = re.compile(rb"(?m)^[^/\n]*?/" + _ARROW_HDR.pattern)


@dataclass
class SeqFile:
    """A parsed .fasta or .arrow file."""

    prefix: bytes             # first header up to first '/', including '>'
    wells: np.ndarray         # (N,) int32
    begs: np.ndarray          # (N,) int32
    ends: np.ndarray          # (N,) int32
    qvs: np.ndarray | None    # (N,) int32 (fasta) or None (arrow)
    snrs: np.ndarray | None   # (N, 4) float32 (arrow) or None (fasta)
    seqs: Ragged              # ascii symbol bytes, newline-free


def _split_lines(data: bytes):
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


def parse_seq_file(data: bytes, arrow: bool = False) -> SeqFile:
    """Parse a .fasta (arrow=False) or .arrow (arrow=True) file."""
    fast = _parse_seq_file_native(data, arrow)
    if fast is not None:
        return fast
    buf, starts, ends = _split_lines(data)
    is_hdr = buf[starts] == ord(">")
    if not is_hdr[0]:
        raise FormatError("first header in file is missing")
    hdr_idx = np.flatnonzero(is_hdr)
    n = len(hdr_idx)

    # record id for every line, then per-sequence-byte
    rec_of_line = np.cumsum(is_hdr) - 1
    line_lens = ends - starts                       # without newline
    seq_mask = ~is_hdr
    seq_line_lens = np.where(seq_mask, line_lens, 0)
    lengths = np.bincount(rec_of_line, weights=seq_line_lens, minlength=n).astype(np.int64)

    # gather all sequence bytes (drop header lines and newlines): one
    # memcpy per sequence line via the native shim; the NumPy fallback
    # builds a whole-file keep mask (two 8-byte-per-input-byte passes)
    seq_idx = np.flatnonzero(seq_mask)
    s_starts = np.ascontiguousarray(starts[seq_idx].astype(np.int64))
    s_lens = np.ascontiguousarray(line_lens[seq_idx].astype(np.int64))
    total = int(s_lens.sum())
    flat = None
    try:
        from ..native import qv_encode_shim
        import ctypes

        lib = qv_encode_shim()
        flat = np.empty(max(total, 1), np.uint8)[:total]
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.dxt_gather_copy(ptr(flat), ptr(buf), ptr(s_starts),
                            ptr(s_lens), len(seq_idx))
    except OSError:
        pass
    if flat is None:
        keep = np.ones(len(buf), bool)
        keep[ends] = False                          # newlines
        if n:
            hdr_starts = starts[hdr_idx]
            hdr_ends = ends[hdr_idx]
            delta = np.zeros(len(buf) + 1, np.int64)
            delta[hdr_starts] += 1
            delta[hdr_ends] -= 1
            keep &= np.cumsum(delta[:-1]) == 0
        flat = buf[keep]

    # parse headers: one anchored bulk findall over the joined header
    # lines (C-level), numeric fields converted columnwise by NumPy; any
    # shape mismatch falls back to the exact per-line loop for the error
    prefix, fields = _parse_headers_bulk(data, starts[hdr_idx], ends[hdr_idx],
                                         n, arrow)
    if fields is None:
        prefix, fields = _parse_headers_loop(data, starts[hdr_idx],
                                             ends[hdr_idx], n, arrow)
    wells, begs, ends_f, qvs, snrs = fields

    return SeqFile(prefix=prefix, wells=wells, begs=begs, ends=ends_f,
                   qvs=qvs, snrs=snrs, seqs=Ragged(flat, lengths))


def _parse_seq_file_native(data: bytes, arrow: bool) -> SeqFile | None:
    """Single-pass native line scan + bulk header parse; None when the
    shim is unavailable (the NumPy mask path then takes over)."""
    try:
        from ..native import twobit_host_shim
        import ctypes

        lib = twobit_host_shim()
    except OSError:
        return None
    if len(data) == 0:
        raise FormatError("empty sequence file")
    if data[-1:] != b"\n":
        raise FormatError("last line does not end with a newline")
    if data[:1] != b">":
        raise FormatError("first header in file is missing")
    buf = np.frombuffer(data, np.uint8)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    counts = np.zeros(2, np.int64)
    lib.dxt_line_stats(ptr(buf), len(buf), ord(">"),
                       ptr(counts[0:1]), ptr(counts[1:2]))
    n = int(counts[1])
    hdr_starts = np.empty(n, np.int64)
    hdr_ends = np.empty(n, np.int64)
    rec_lens = np.empty(n, np.int64)
    flat = np.empty(len(buf), np.uint8)
    total = int(lib.dxt_seq_scan(ptr(buf), len(buf), ord(">"),
                                 ptr(hdr_starts), ptr(hdr_ends),
                                 ptr(flat), ptr(rec_lens)))
    flat = flat[:total]
    prefix, fields = _parse_headers_bulk(data, hdr_starts, hdr_ends, n, arrow)
    if fields is None:
        prefix, fields = _parse_headers_loop(data, hdr_starts, hdr_ends,
                                             n, arrow)
    wells, begs, ends_f, qvs, snrs = fields
    return SeqFile(prefix=prefix, wells=wells, begs=begs, ends=ends_f,
                   qvs=qvs, snrs=snrs, seqs=Ragged(flat, rec_lens))


def _parse_headers_bulk(data: bytes, hdr_starts, hdr_ends, n: int, arrow: bool):
    """Vectorized header parse; returns (prefix, fields) or (prefix, None)
    when the fast path cannot certify a 1:1 line:match correspondence."""
    if n == 0:
        z = np.zeros(0, np.int32)
        return b"", (z, z, z, None if arrow else z,
                     np.zeros((0, 4), np.float32) if arrow else None)
    first = data[hdr_starts[0]:hdr_ends[0]]
    slash = first.find(b"/")
    if slash < 0:
        raise FormatError("header line incorrectly formatted ?")
    prefix = first[:slash]
    blob = b"\n".join(
        bytes(memoryview(data)[hs:he]) for hs, he in zip(hdr_starts, hdr_ends)
    ) if n > 1 else first
    pattern = _ARROW_HDR_LINE if arrow else _FASTA_HDR_LINE
    ms = pattern.findall(blob)
    if len(ms) != n or blob.count(b"\n") != n - 1:
        return prefix, None
    cols = np.array(ms, dtype=np.bytes_)
    try:
        wells = cols[:, 0].astype(np.int32)
        begs = cols[:, 1].astype(np.int32)
        ends_f = cols[:, 2].astype(np.int32)
        if arrow:
            snrs = cols[:, 3:7].astype(np.float32)
            return prefix, (wells, begs, ends_f, None, snrs)
        q = cols[:, 3]
        qvs = np.where(q == b"", b"0", q).astype(np.int32)
        return prefix, (wells, begs, ends_f, qvs, None)
    except ValueError:
        return prefix, None


def _parse_headers_loop(data: bytes, hdr_starts, hdr_ends, n: int, arrow: bool):
    """Reference-faithful per-line header parse (dexta.c:151-157,
    dexar.c:152-157); also the error path for malformed headers."""
    wells = np.zeros(n, np.int32)
    begs = np.zeros(n, np.int32)
    ends_f = np.zeros(n, np.int32)
    qvs = np.zeros(n, np.int32) if not arrow else None
    snrs = np.zeros((n, 4), np.float32) if arrow else None
    pattern = _ARROW_HDR if arrow else _FASTA_HDR
    prefix = b""
    data_mv = memoryview(data)
    for i, (hs, he) in enumerate(zip(hdr_starts, hdr_ends)):
        line = bytes(data_mv[hs:he])
        slash = line.find(b"/")
        if slash < 0:
            raise FormatError("header line incorrectly formatted ?")
        if i == 0:
            prefix = line[:slash]
        m = pattern.match(line, slash + 1)
        if m is None:
            raise FormatError("header line incorrectly formatted ?")
        wells[i] = int(m.group(1))
        begs[i] = int(m.group(2))
        ends_f[i] = int(m.group(3))
        if arrow:
            snrs[i] = [np.float32(m.group(k)) for k in (4, 5, 6, 7)]
        elif m.group(4) is not None:
            qvs[i] = int(m.group(4))
    return prefix, (wells, begs, ends_f, qvs, snrs)


def format_headers(prefix: bytes, wells, begs, ends, qvs=None, snrs=None) -> list[bytes]:
    """Per-read header lines (no trailing newline).

    fasta: ``prefix/well/beg_end RQ=0.qv`` (undexta.c:242);
    arrow: ``prefix/well/beg_end SN=%.2f,%.2f,%.2f,%.2f`` (undexar.c:202).
    """
    out = []
    if snrs is None:
        for w, b, e, q in zip(wells.tolist(), begs.tolist(), ends.tolist(), qvs.tolist()):
            out.append(prefix + f"/{w}/{b}_{e} RQ=0.{q}".encode())
    else:
        for w, b, e, s in zip(wells.tolist(), begs.tolist(), ends.tolist(), snrs.tolist()):
            out.append(
                prefix + f"/{w}/{b}_{e} SN={s[0]:.2f},{s[1]:.2f},{s[2]:.2f},{s[3]:.2f}".encode()
            )
    return out


def write_seq_file(headers: list[bytes], symbols: np.ndarray, lengths: np.ndarray,
                   width: int = 80) -> bytes:
    """Assemble a .fasta/.arrow text image with ``width``-wrapped lines
    (``width`` <= 0: no wrap).

    ``symbols`` holds the ascii symbols of every read end to end, read i
    having ``lengths[i]``.  The buffer is pre-filled with '\\n', so the
    newlines are the bytes never written; headers and text lines each go
    in with one native memcpy (the NumPy fallback scatters per byte).
    """
    from .dexqv import _ragged_copier

    n = len(headers)
    lengths = np.asarray(lengths, np.int64)
    if width <= 0:
        width = 1 << 62                     # no wrap within a read
    nlines = np.maximum((lengths + width - 1) // width, 0)
    hdr_lens = np.array([len(h) for h in headers], np.int64)
    blk_lens = hdr_lens + 1 + lengths + nlines   # header + \n + seq + newlines
    blk_off = np.zeros(n + 1, np.int64)
    np.cumsum(blk_lens, out=blk_off[1:])
    out = np.full(int(blk_off[-1]), ord("\n"), np.uint8)

    # line k of read i: min(width, len - k*width) symbols at
    # blk_off + hdr_len + 1 + k*(width+1); lines follow each other in
    # ``symbols``, so each is the next run of a ragged copy
    n_lines = int(nlines.sum())
    line_read = np.repeat(np.arange(n, dtype=np.int64), nlines)
    first = np.zeros(n, np.int64)
    np.cumsum(nlines[:-1], out=first[1:])
    k = np.arange(n_lines, dtype=np.int64) - first[line_read]
    line_lens = np.minimum(width, lengths[line_read] - k * width)
    line_dst = (blk_off[:-1] + hdr_lens + 1)[line_read] + k * (width + 1)
    hdr_flat = np.frombuffer(b"".join(headers), np.uint8)
    sym = np.ascontiguousarray(symbols[:int(lengths.sum())], np.uint8)
    copier = _ragged_copier()
    for dst, src, lens in ((blk_off[:-1], hdr_flat, hdr_lens),
                           (line_dst, sym, line_lens)):
        total = int(lens.sum())
        if not total:
            continue
        dst = np.ascontiguousarray(dst)
        lens = np.ascontiguousarray(lens)
        if copier is not None:
            copier(out.ctypes.data, dst.ctypes.data, src.ctypes.data,
                   lens.ctypes.data, len(lens))
        else:
            starts = np.zeros(len(lens), np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            pos = (np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
                   + np.repeat(dst, lens))
            out[pos] = src[:total]
    return out.tobytes()
