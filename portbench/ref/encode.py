"""The plain reference encoder of .dexqv: a whole .quiva file in NumPy.

It follows DEXTRACTOR's dexqv (dexqv.c:79-143, QV.c): a statistics scan
over the file (``QVcoding_Scan``, QV.c:860-1023, with its order-dependent
delChar and subChar elections), one Huffman coding for the file
(``Create_QVcoding``, QV.c:1029-1153), then each entry's five streams
(``Compress_Next_QVentry``, QV.c:1381-1426): delQV plain or run-length
coded, the delTag letters that survive ``Pack_Tag`` as 2-bit codes, insQV,
mergeQV, and subQV plain or run-length coded.  Every stream is 32-bit
words written most significant bit first, with the encoder's tail rule
(QV.c:436-442): a partial last word is written twice when the last
emission left more than 16 bits in it and fewer than the partial word
holds, and a zero word follows a full last word under the same condition.

The encoder works on every entry of a channel at once (no loop over
entries), imports nothing of the program under test, and is the yardstick
that the benchmark's ``correct`` holds the program's outputs against.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .gen import DEL, INS, MRG, SUB, TAG, QuivaData
from .huffman import Scheme, make_scheme, scheme_bytes

CODEC_KEY = 0x33CC
CONTAINER_KEY = 0x55AA

# delTag letter -> 2-bit code (Number_Read): a c g t in either case, else 0
BASE_CODE = np.zeros(256, np.uint8)
for _i, _ch in enumerate(b"acgt"):
    BASE_CODE[_ch] = _i
    BASE_CODE[_ch - 32] = _i


@dataclass
class Coding:
    del_scheme: Scheme
    ins_scheme: Scheme
    mrg_scheme: Scheme
    sub_scheme: Scheme
    drun_scheme: Scheme | None
    srun_scheme: Scheme | None
    del_char: int            # -1: delQV is plain
    sub_char: int            # -1: subQV is plain
    prefix: bytes


@dataclass
class Encoded:
    """A reference-encoded file: the image and, per channel (del, tag, ins,
    mrg, sub), the entries' stream bytes butted (flat u8) and each entry's
    byte count; ``kept`` is each entry's delTag count after Pack_Tag."""
    coding: Coding
    image: bytes
    parts: list
    kept: np.ndarray

    def entry_bytes(self) -> np.ndarray:
        """Each entry's compressed stream bytes (headers left out)."""
        return sum(lens for _, lens in self.parts)


def _offsets(lengths: np.ndarray) -> np.ndarray:
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    return off


def _excl(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), np.int64)
    if len(x) > 1:
        np.cumsum(x[:-1], out=out[1:])
    return out


def _run_hist(seg: np.ndarray, bnd: np.ndarray, rchar: int) -> np.ndarray:
    """Histogram_Runs (QV.c:702-724) over the entries bounded by ``bnd`` in
    ``seg``: the rchar run before each literal and each entry's trailing
    run (its whole length when it has no literal), clamped at 255."""
    hist = np.zeros(256, np.int64)
    lits = np.flatnonzero(seg != rchar)
    nxt = np.searchsorted(lits, bnd, "left")
    has_lit = nxt[:-1] < nxt[1:]
    if len(lits):
        prev = np.concatenate([[np.int64(-1)], lits[:-1]])
        runlens = lits - prev - 1
        first = nxt[:-1][has_lit]
        runlens[first] = lits[first] - bnd[:-1][has_lit]
        hist += np.bincount(np.minimum(runlens, 255), minlength=256)
    last_end = np.where(has_lit,
                        lits[np.maximum(nxt[1:] - 1, 0)] + 1 if len(lits) else np.int64(0),
                        bnd[:-1])
    trail = bnd[1:] - last_end
    trail = trail[trail > 0]
    if len(trail):
        hist += np.bincount(np.minimum(trail, 255), minlength=256)
    return hist


def _runs_from(stream: np.ndarray, off: np.ndarray, r0: int, rchar: int) -> np.ndarray:
    lo, hi = int(off[r0]), int(off[-1])
    if hi <= lo:
        return np.zeros(256, np.int64)
    return _run_hist(stream[lo:hi], off[r0:] - lo, rchar)


def make_coding(streams: np.ndarray, lengths: np.ndarray, prefix: bytes,
                lossy: bool = False) -> Coding:
    """QVcoding_Scan and Create_QVcoding over a whole file."""
    off = _offsets(lengths)
    total = int(off[-1])
    del_h, ins_h, mrg_h, sub_h = (np.bincount(streams[c], minlength=256).astype(np.int64)
                                  for c in (DEL, INS, MRG, SUB))
    tagn = np.flatnonzero((streams[TAG] == ord("n")) | (streams[TAG] == ord("N")))

    # delChar: the delQV under the first 'n'/'N' delTag; its runs are
    # counted from that entry on (QV.c:993-1002); the run histograms start at 1
    del_run = np.ones(256, np.int64)
    del_char = -1
    if len(tagn):
        k = int(tagn[0])
        del_char = int(streams[DEL][k])
        del_run += _runs_from(streams[DEL], off, int(np.searchsorted(off, k, "right") - 1),
                              del_char)
    # subChar: the mode of subQV up to the first entry that brings the
    # count to 100,000 symbols, its runs counted from that entry on
    sub_run = np.ones(256, np.int64)
    sub_char = -1
    if total >= 100000:
        r1 = int(np.searchsorted(off[1:], 100000, "left"))
        sub_char = int(np.argmax(np.bincount(streams[SUB][:off[r1 + 1]], minlength=256)))
        sub_run += _runs_from(streams[SUB], off, r1, sub_char)

    # Create_QVcoding: subChar stays only where it is half of all symbols
    if total < 200000 or sub_h[sub_char] < 0.5 * total:
        sub_char = -1
    if lossy:
        ins_h = np.stack([ins_h.reshape(128, 2).sum(1), np.zeros(128, np.int64)], 1).reshape(256)
        mrg_h = np.concatenate([mrg_h.reshape(64, 4).sum(1)[:, None],
                                np.zeros((64, 3), np.int64)], 1).reshape(256)
    drun = srun = None
    if del_char >= 0:
        del_h = del_h.copy()
        del_h[del_char] = 0
        drun = make_scheme(del_run)
    if sub_char >= 0:
        sub_h = sub_h.copy()
        sub_h[sub_char] = 0
        srun = make_scheme(sub_run)
    return Coding(make_scheme(del_h), make_scheme(ins_h), make_scheme(mrg_h),
                  make_scheme(sub_h), drun, srun, del_char, sub_char, prefix)


def coding_bytes(c: Coding) -> bytes:
    """Write_QVcoding (QV.c:1173-1240)."""
    out = bytearray(struct.pack("<HHHi", CODEC_KEY, 256 if c.del_char < 0 else c.del_char,
                                256 if c.sub_char < 0 else c.sub_char, len(c.prefix)))
    out += c.prefix
    for s in (c.del_scheme, c.drun_scheme, c.ins_scheme, c.mrg_scheme, c.sub_scheme,
              c.srun_scheme):
        if s is not None:
            out += scheme_bytes(s)
    return bytes(out)


def _emissions(scheme: Scheme, data: np.ndarray):
    """Per symbol (value, bits, bits of its last OCODE): an escaped symbol
    of a type-2 scheme is its escape code and its 8-bit literal."""
    lens = scheme.codelens[data].astype(np.int64)
    bits = scheme.codebits[data].astype(np.uint64)
    if scheme.type == 2:
        esc = ((scheme.codebits[data] == scheme.codebits[255])
               & (scheme.codelens[data] == scheme.codelens[255]))
    else:
        esc = np.zeros(len(data), bool)
    v = np.where(esc, (bits << np.uint64(8)) | data.astype(np.uint64), bits)
    return v, np.where(esc, lens + 8, lens), np.where(esc, 8, lens)


def _words(values, nbits, lastbits, eid, n: int):
    """Emissions of n entries (in entry order; ``eid`` each one's entry) ->
    (the entries' stream words butted, u32; each entry's word count)."""
    keep = nbits > 0
    if not keep.all():
        values, nbits, lastbits, eid = values[keep], nbits[keep], lastbits[keep], eid[keep]
    cnt = np.bincount(eid, minlength=n)
    tot = np.bincount(eid, weights=nbits, minlength=n).astype(np.int64)
    last = np.cumsum(cnt) - 1
    lastb = np.where(cnt > 0, lastbits[np.maximum(last, 0)] if len(lastbits) else 0, 0)
    olen = tot & 31
    llen = (tot - lastb) & 31
    dup = (olen > 0) & (llen > 16) & (olen > llen)
    zext = (olen == 0) & (llen > 16)
    raw = (tot >> 5) + (olen > 0)
    nw = raw + dup + zext
    wbase = _excl(nw)
    nwords = int(nw.sum())
    if nwords == 0:
        return np.empty(0, np.uint32), nw
    off = np.cumsum(nbits) - nbits - _excl(tot)[eid]
    w = wbase[eid] + (off >> 5)
    chunk = values << (np.uint64(64) - ((off & 31) + nbits).astype(np.uint64))
    words = np.zeros(nwords + 1, np.uint64)
    # w never decreases: OR the high halves of each word's emissions
    # together; a low half is not 0 only for the one emission that crosses
    # into the next word
    first = np.flatnonzero(np.concatenate([[True], w[1:] != w[:-1]]))
    words[w[first]] = np.bitwise_or.reduceat(chunk >> np.uint64(32), first)
    lo = chunk & np.uint64(0xFFFFFFFF)
    cross = np.flatnonzero(lo)
    words[w[cross] + 1] |= lo[cross]
    words = words[:nwords].astype(np.uint32)
    d = np.flatnonzero(dup)
    words[wbase[d] + raw[d]] = words[wbase[d] + raw[d] - 1]
    return words, nw


def plain_streams(scheme: Scheme, data: np.ndarray, lengths: np.ndarray):
    """Encode (QV.c:386-443) of every entry: (words, word counts)."""
    n = len(lengths)
    v, nb, last = _emissions(scheme, data)
    return _words(v, nb, last, np.repeat(np.arange(n), lengths), n)


def run_streams(neme: Scheme, reme: Scheme, data: np.ndarray, lengths: np.ndarray,
                rchar: int):
    """Encode_Run (QV.c:448-506) of every entry: per literal the run of
    ``rchar`` before it (in the run scheme, clamped at 255; an escape code
    carries the length as a 16-bit literal) and the literal, then a
    trailing run token where an entry ends in ``rchar``."""
    n = len(lengths)
    off = _offsets(lengths)
    lit = np.flatnonzero(data != rchar)
    ent = np.searchsorted(off, lit, "right") - 1
    prev_end = np.concatenate([[np.int64(-1)], lit[:-1]]) + 1
    fresh = np.concatenate([[True], ent[1:] != ent[:-1]]) if len(lit) else np.zeros(0, bool)
    prev_end[fresh] = off[ent[fresh]]
    cnt = np.bincount(ent, minlength=n)
    last = np.cumsum(cnt) - 1
    last_end = np.where(cnt > 0, lit[np.maximum(last, 0)] + 1 if len(lit) else 0, off[:-1])
    trail = off[1:] - last_end
    has_trail = trail > 0

    # tokens in entry order: an entry's literals, then its trailing run
    tr_before = _excl(has_trail.astype(np.int64))
    ntok = len(lit) + int(has_trail.sum())
    runlen = np.zeros(ntok, np.int64)
    sym = np.zeros(ntok, np.uint8)
    is_lit = np.zeros(ntok, bool)
    teid = np.zeros(ntok, np.int64)
    li = np.arange(len(lit)) + tr_before[ent]
    runlen[li] = lit - prev_end
    sym[li] = data[lit]
    is_lit[li] = True
    teid[li] = ent
    te = np.flatnonzero(has_trail)
    ti = np.cumsum(cnt)[te] + tr_before[te]
    runlen[ti] = trail[te]
    teid[ti] = te

    x = np.minimum(runlen, 255)
    rl = reme.codelens[x].astype(np.int64)
    rb = reme.codebits[x].astype(np.uint64)
    resc = (reme.codebits[x] == reme.codebits[255]) & (reme.codelens[x] == reme.codelens[255])
    sv, sn, sl = _emissions(neme, sym)
    values = np.empty(2 * ntok, np.uint64)
    nbits = np.empty(2 * ntok, np.int64)
    lastb = np.empty(2 * ntok, np.int64)
    values[0::2] = np.where(resc, (rb << np.uint64(16)) | (runlen.astype(np.uint64)
                                                          & np.uint64(0xFFFF)), rb)
    nbits[0::2] = np.where(resc, rl + 16, rl)
    lastb[0::2] = np.where(resc, 16, rl)
    values[1::2] = np.where(is_lit, sv, np.uint64(0))
    nbits[1::2] = np.where(is_lit, sn, 0)
    lastb[1::2] = np.where(is_lit, sl, 0)
    return _words(values, nbits, lastb, np.repeat(teid, 2), n)


def tag_streams(tag: np.ndarray, dele: np.ndarray, lengths: np.ndarray, del_char: int):
    """Pack_Tag and Compress_Read (QV.c:810-819): the delTags where delQV is
    not delChar (all where there is none), 2-bit codes, the first in bits
    7-6.  Returns (bytes, per-entry byte counts, per-entry kept counts)."""
    n = len(lengths)
    eid = np.repeat(np.arange(n), lengths)
    keep = dele != del_char if del_char >= 0 else np.ones(len(tag), bool)
    codes = BASE_CODE[tag[keep]].astype(np.int64)
    keid = eid[keep]
    kept = np.bincount(keid, minlength=n).astype(np.int64)
    rank = np.arange(len(codes)) - _excl(kept)[keid]
    nbytes = (kept + 3) >> 2
    pos = _excl(nbytes)[keid] + (rank >> 2)
    out = np.bincount(pos, weights=(codes << (6 - 2 * (rank & 3))).astype(np.float64),
                      minlength=int(nbytes.sum()))
    return out.astype(np.uint8), nbytes, kept


def assemble(coding: Coding, q: QuivaData, parts) -> bytes:
    """The container: its key, the coding, then per entry the well's delta
    (255s and a last byte), beg, end and qv as int32, and the five streams."""
    n = len(q.lengths)
    deltas = np.diff(q.wells.astype(np.int64), prepend=0)
    n_ff = deltas // 255
    hdr = n_ff + 13
    lens = [np.asarray(l, np.int64) for _, l in parts]
    eoff = _excl(hdr + sum(lens))
    total = int(eoff[-1] + hdr[-1] + sum(l[-1] for l in lens)) if n else 0
    out = np.empty(total, np.uint8)
    if int(n_ff.sum()):
        out[_positions(eoff, n_ff)] = 0xFF
    out[eoff + n_ff] = (deltas - 255 * n_ff).astype(np.uint8)
    fields = np.stack([q.begs, q.ends, q.qvs], 1).astype("<i4").view(np.uint8)
    out[(eoff + n_ff + 1)[:, None] + np.arange(12)] = fields
    base = eoff + hdr
    for (flat, _), ln in zip(parts, lens):
        out[_positions(base, ln)] = flat
        base = base + ln
    return struct.pack("<H", CONTAINER_KEY) + coding_bytes(coding) + out.tobytes()


def _positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    return np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(_excl(lens) - starts, lens)


def encode(q: QuivaData, lossy: bool = False, workers: int = 5) -> Encoded:
    """dexqv of one file (with ``lossy``, dexqv -l: insQV and mergeQV
    quantised, QV.c:1049-1065 and 1406-1415), its channels on ``workers``
    threads."""
    s = q.streams
    ins, mrg = s[INS], s[MRG]
    if lossy:
        ins, mrg = ins & 0xFE, mrg & 0xFC
    c = make_coding(s, q.lengths, q.prefix, lossy)

    def chan(data, scheme, run_scheme, rchar):
        if rchar < 0:
            words, nw = plain_streams(scheme, data, q.lengths)
        else:
            words, nw = run_streams(scheme, run_scheme, data, q.lengths, rchar)
        return words.astype("<u4").view(np.uint8), 4 * nw

    # NumPy releases the interpreter lock in its loops: the channels run
    # side by side
    with ThreadPoolExecutor(max_workers=workers) as ex:
        jobs = [ex.submit(chan, s[DEL], c.del_scheme, c.drun_scheme, c.del_char),
                ex.submit(tag_streams, s[TAG], s[DEL], q.lengths, c.del_char),
                ex.submit(chan, ins, c.ins_scheme, None, -1),
                ex.submit(chan, mrg, c.mrg_scheme, None, -1),
                ex.submit(chan, s[SUB], c.sub_scheme, c.srun_scheme, c.sub_char)]
        parts = [j.result() for j in jobs]
    tag, tlens, kept = parts[1]
    parts[1] = (tag, tlens)
    return Encoded(c, assemble(c, q, parts), parts, kept)
