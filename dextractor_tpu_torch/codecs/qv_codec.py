""".quiva <-> .dexqv (``dextractor_tpu/codecs/qv_codec.py``).

Two-pass flow matching dexqv.c:79-143: a statistics scan over the whole
file builds six histograms (with the reference's order-dependent
delChar/subChar discovery, QV.c:895-918), the Huffman schemes are built
once per file (QV.c:1029-1136), then every entry's five streams are
encoded — by the native C channel encoder on the host (``device=False``)
or as batched device steps (parallel/pipeline.qv_encode_step), one per
quarter-octave row-length bucket (``encode_buckets``).  Where a native
shim cannot build (no C compiler), each host step takes the JAX package's
NumPy fallback: the scan's histograms, the ragged copies, and on the host
path the per-entry encoder (``encode_entry``, ops/bitstream.py).

Decode (undexqv.c:101-208) parses the coding, then either walks every entry
with the native sequential decoder on the host (``device=False``) or lets
the native lens walk find the entries' channel offsets and decodes all of
them as parallel chains on the device (codecs/qv_batch); when a read
crosses ``SEG_DECODE`` symbols, a second lens walk records checkpoints and
the reads decode as chains of at most that many symbols.  A container
written on a host of the other byte order decodes on the Python walker
(``decode_entry``, ops/bitstream.py) in every mode, as in the JAX package;
so does every container when the native walker cannot build.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..formats import dexqv as dq
from ..formats import quiva as qv
from ..formats.ragged import (bucket_len, bucket_rows, pad_rows, padded_width,
                              rows_to_flat)
from ..native import qv_decode_shim, qv_encode_shim
from ..ops import bitstream as bs
from ..ops import bitstream_torch as bt
from ..ops import twobit as tb
from ..ops.huffman import make_scheme
from ..parallel.mesh import check_device
from ..parallel.pipeline import null_run_luts, qv_encode_step
from ..utils.dispatch import resolve_device
from ..utils.errors import FormatError
from ..utils.profiling import stage

DEL, TAG, INS, MRG, SUB = range(5)


@dataclass
class QVStats:
    del_hist: np.ndarray
    ins_hist: np.ndarray
    mrg_hist: np.ndarray
    sub_hist: np.ndarray
    del_run: np.ndarray
    sub_run: np.ndarray
    del_char: int
    sub_char: int
    tot_char: int


def _ptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.c_void_p)


def _run_hist_entries(streams_flat, offsets, r0, rchar):
    """Histogram_Runs (QV.c:702-724) over entries [r0, n): one run token
    (the rchar run length, possibly 0) before each literal, plus a trailing
    symbol-less run token when an entry ends in rchar characters.  One
    native pass, or NumPy over the flat region when the shim cannot build."""
    lo, hi = int(offsets[r0]), int(offsets[-1])
    hist = np.zeros(256, np.int64)
    if hi <= lo:
        return hist
    seg = np.ascontiguousarray(streams_flat[lo:hi])
    bnd = np.ascontiguousarray(np.asarray(offsets[r0:], np.int64) - lo)
    try:
        lib = qv_encode_shim()
    except OSError:
        return _run_hist_np(seg, bnd, rchar)
    lib.dxt_run_hist(_ptr(seg), _ptr(bnd), len(bnd) - 1, int(rchar), _ptr(hist))
    return hist


def _run_hist_np(seg, bnd, rchar):
    """``_run_hist_entries`` in NumPy: ``seg`` the flat symbols, ``bnd``
    the entry boundaries in it (0 .. len(seg))."""
    hist = np.zeros(256, np.int64)
    lits = np.flatnonzero(seg != rchar)
    # nxt[i]: the first literal at or after boundary i
    nxt = np.searchsorted(lits, bnd, "left")
    has_lit = nxt[:-1] < nxt[1:]
    if len(lits):
        prev = np.concatenate([[np.int64(-1)], lits[:-1]])
        runlens = lits - prev - 1                    # gap to the previous literal
        first = nxt[:-1][has_lit]                    # first literal of each entry
        runlens[first] = lits[first] - bnd[:-1][has_lit]
        hist += np.bincount(np.minimum(runlens, 255), minlength=256)
    # the trailing run of each entry (after its last literal; the whole
    # entry when it has none); entries of length 0 add nothing
    last_end = np.where(has_lit,
                        lits[np.maximum(nxt[1:] - 1, 0)] + 1 if len(lits) else np.int64(0),
                        bnd[:-1])
    trail = bnd[1:] - last_end
    trail = trail[trail > 0]
    if len(trail):
        hist += np.bincount(np.minimum(trail, 255), minlength=256)
    return hist


def scan_streams(streams: np.ndarray, lengths: np.ndarray) -> QVStats:
    """QVcoding_Scan / QVcoding_Scan1 (QV.c:860-1023) with the reference's
    exact order-dependent semantics.  ``streams`` is (5, total) u8 with
    entry boundaries given by ``lengths``."""
    n_entries = len(lengths)
    off = np.zeros(n_entries + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    total = int(off[-1])

    # one native pass for the four flat histograms and the first 'n'/'N'
    # delTag in file order; NumPy when the shim cannot build
    try:
        lib = qv_encode_shim()
    except OSError:
        del_hist, ins_hist, mrg_hist, sub_hist = (
            np.bincount(streams[c], minlength=256).astype(np.int64)
            for c in (DEL, INS, MRG, SUB))
        tagn = np.flatnonzero((streams[TAG] == ord("n")) | (streams[TAG] == ord("N")))
        first_n = int(tagn[0]) if len(tagn) else -1
    else:
        hist4 = np.zeros((4, 256), np.int64)
        fn = np.zeros(1, np.int64)
        rows = [np.ascontiguousarray(streams[c]) for c in (DEL, INS, MRG, SUB, TAG)]
        lib.dxt_qv_scan_hists(*(_ptr(r) for r in rows), total, _ptr(hist4), _ptr(fn))
        del_hist, ins_hist, mrg_hist, sub_hist = hist4
        first_n = int(fn[0])

    # delChar: the delQV under the first 'n'/'N' delTag (QV.c:993-1002);
    # its run histogram covers that entry onward.
    del_run = np.ones(256, np.int64)                    # init to 1 (QV.c:934-935)
    if first_n >= 0:
        k = first_n
        del_char = int(streams[DEL][k])
        r0 = int(np.searchsorted(off, k, "right") - 1)
        del_run += _run_hist_entries(streams[DEL], off, r0, del_char)
    else:
        del_char = -1

    # subChar: chosen at the first entry where cumulative chars >= 100000,
    # as the mode of the substitution histogram so far (QV.c:1006-1017);
    # its run histogram covers that entry onward.
    sub_run = np.ones(256, np.int64)
    sub_char = -1
    if total >= 100000:
        r1 = int(np.searchsorted(off[1:], 100000, "left"))
        part = np.bincount(streams[SUB][: off[r1 + 1]], minlength=256)
        sub_char = int(np.argmax(part))                  # first max, like the C scan
        sub_run += _run_hist_entries(streams[SUB], off, r1, sub_char)

    return QVStats(del_hist, ins_hist, mrg_hist, sub_hist, del_run, sub_run,
                   del_char, sub_char, total)


def scan_quiva(q: qv.QuivaFile) -> QVStats:
    return scan_streams(q.streams, q.lengths)


def create_qvcoding(stats: QVStats, prefix: bytes, lossy: bool = False) -> dq.QVCoding:
    """Create_QVcoding (QV.c:1029-1153)."""
    del_hist = stats.del_hist.copy()
    ins_hist = stats.ins_hist.copy()
    mrg_hist = stats.mrg_hist.copy()
    sub_hist = stats.sub_hist.copy()
    del_char, sub_char = stats.del_char, stats.sub_char

    # keep subChar only if it is at least half of all chars (QV.c:1044-1045)
    if stats.tot_char < 200000 or sub_hist[sub_char] < 0.5 * stats.tot_char:
        sub_char = -1

    if lossy:                                            # QV.c:1049-1065
        ins_hist = ins_hist.reshape(128, 2).sum(1, dtype=np.int64)
        ins_hist = np.stack([ins_hist, np.zeros(128, np.int64)], 1).reshape(256)
        mrg_hist = mrg_hist.reshape(64, 4).sum(1, dtype=np.int64)
        mrg_hist = np.concatenate(
            [mrg_hist[:, None], np.zeros((64, 3), np.int64)], 1).reshape(256)

    if del_char >= 0:
        del_hist[del_char] = 0
        del_scheme = make_scheme(del_hist)
        drun_scheme = make_scheme(stats.del_run)
    else:
        del_scheme = make_scheme(del_hist)
        drun_scheme = None

    ins_scheme = make_scheme(ins_hist)
    mrg_scheme = make_scheme(mrg_hist)

    if sub_char >= 0:
        sub_hist[sub_char] = 0
        sub_scheme = make_scheme(sub_hist)
        srun_scheme = make_scheme(stats.sub_run)
    else:
        sub_scheme = make_scheme(sub_hist)
        srun_scheme = None

    return dq.QVCoding(del_scheme, ins_scheme, mrg_scheme, sub_scheme,
                       drun_scheme, srun_scheme, del_char, sub_char, prefix)


def step_tables(coding: dq.QVCoding):
    """The coding as qv_encode_step's tables: (sym_luts (4, 256),
    run_luts (4, 256), rchars (4,), number_lut (256,), run_on)."""
    sym = np.stack([bt.scheme_luts(s) for s in (
        coding.del_scheme, coding.ins_scheme, coding.mrg_scheme,
        coding.sub_scheme)])
    run = np.stack([
        bt.scheme_luts(coding.drun_scheme, run=True)
        if coding.drun_scheme else null_run_luts(),
        null_run_luts(),
        null_run_luts(),
        bt.scheme_luts(coding.srun_scheme, run=True)
        if coding.srun_scheme else null_run_luts(),
    ])
    rchars = np.array([coding.del_char, -1, -1, coding.sub_char], np.int32)
    run_on = (coding.drun_scheme is not None, coding.srun_scheme is not None)
    return sym, run, rchars, tb.NUMBER_BASE_LUT, run_on


def encode_entry(coding: dq.QVCoding, delqv, tag, ins, mrg, sub, lossy: bool) -> bytes:
    """Compress_Next_QVentry (QV.c:1381-1426) for one entry -> payload bytes."""
    parts = []
    if coding.del_char < 0:
        parts.append(bs.encode_stream(coding.del_scheme, delqv).tobytes())
        kept = tag
    else:
        parts.append(bs.encode_run_stream(coding.del_scheme, coding.drun_scheme,
                                          delqv, coding.del_char).tobytes())
        kept = tag[delqv != coding.del_char]              # Pack_Tag (QV.c:810-819)
    codes = tb.NUMBER_BASE_LUT[kept]
    clen = len(codes)
    tlen = (clen + 3) >> 2
    if tlen:
        padded = np.zeros(4 * tlen, np.uint8)
        padded[:clen] = codes
        parts.append(tb.pack_2bit_np(padded[None, :])[0].tobytes())
    if lossy:                                             # QV.c:1406-1415
        ins = ins & 0xFE
        mrg = mrg & 0xFC
    parts.append(bs.encode_stream(coding.ins_scheme, ins).tobytes())
    parts.append(bs.encode_stream(coding.mrg_scheme, mrg).tobytes())
    if coding.sub_char < 0:
        parts.append(bs.encode_stream(coding.sub_scheme, sub).tobytes())
    else:
        parts.append(bs.encode_run_stream(coding.sub_scheme, coding.srun_scheme,
                                          sub, coding.sub_char).tobytes())
    return b"".join(parts)


def encode_quiva_to_dexqv(data: bytes, lossy: bool = False, device=None) -> bytes:
    """Encode a .quiva image.

    device=False -> the native C channel encoder on the host (the per-entry
                    NumPy encoder, ``encode_entry``, when its shim cannot
                    build);
    device=True  -> the batched step on the CUDA device (raises without one);
    "cpu" / "cuda" / a torch.device -> the batched step there ("cpu" runs
                    the kernels' plain twins);
    device=None  -> utils/dispatch.device_default(): DXT_DEVICE env
                    override, else CUDA when present.
    """
    with stage("parse", len(data)):
        q = qv.parse_quiva(data)
    payload = int(q.lengths.sum()) * 5
    with stage("scan+tables", payload):
        stats = scan_quiva(q)
        coding = create_qvcoding(stats, q.prefix, lossy)
    dev = resolve_device(device)
    with stage("encode+assemble", payload):
        if dev is not None:
            return _encode_entries_device(q, coding, lossy, dev)
        out = _encode_entries_native(q, coding, lossy)
        if out is not None:
            return out
        off = np.zeros(q.n_entries + 1, np.int64)
        np.cumsum(q.lengths, out=off[1:])
        blobs = [encode_entry(coding, *(q.streams[c, off[i]:off[i + 1]]
                                        for c in (DEL, TAG, INS, MRG, SUB)), lossy)
                 for i in range(q.n_entries)]
        return dq.write_dexqv(coding, q.wells, q.begs, q.ends, q.qvs, blobs)


def _encode_entries_native(q: qv.QuivaFile, coding: dq.QVCoding, lossy: bool):
    """All five channels through the C channel encoder (host CPU path), or
    None when its shim cannot build."""
    from concurrent.futures import ThreadPoolExecutor

    try:
        lib = qv_encode_shim()
    except OSError:
        return None
    n = q.n_entries
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(q.lengths, out=offs[1:])
    total = int(offs[-1])
    cap = 8 * total + 64 * n + 1024

    def channel(data, scheme, run_scheme=None, rchar=-1):
        data = np.ascontiguousarray(data)
        out = np.empty(cap, np.uint8)
        out_lens = np.zeros(n, np.int64)
        bits = np.ascontiguousarray(scheme.codebits.astype(np.uint32))
        lens = np.ascontiguousarray(scheme.codelens.astype(np.int32))
        if run_scheme is None:
            r = lib.dxt_encode_plain(_ptr(data), _ptr(offs), n, _ptr(bits),
                                     _ptr(lens), int(scheme.type), _ptr(out),
                                     cap, _ptr(out_lens))
        else:
            rbits = np.ascontiguousarray(run_scheme.codebits.astype(np.uint32))
            rlens = np.ascontiguousarray(run_scheme.codelens.astype(np.int32))
            r = lib.dxt_encode_run(_ptr(data), _ptr(offs), n, _ptr(bits),
                                   _ptr(lens), int(scheme.type), _ptr(rbits),
                                   _ptr(rlens), int(rchar), _ptr(out), cap,
                                   _ptr(out_lens))
        if r < 0:
            raise FormatError("native encode buffer overflow")
        return out[: int(r)], out_lens

    ins_data = q.streams[INS]
    mrg_data = q.streams[MRG]
    if lossy:
        ins_data = ins_data & 0xFE
        mrg_data = mrg_data & 0xFC

    tag_out = np.empty(total // 4 + 4 * n + 16, np.uint8)
    tag_lens = np.zeros(n, np.int64)

    def tag_job():
        r = lib.dxt_pack_tags(_ptr(np.ascontiguousarray(q.streams[TAG])),
                              _ptr(np.ascontiguousarray(q.streams[DEL])),
                              _ptr(offs), n, coding.del_char,
                              _ptr(tb.NUMBER_BASE_LUT), _ptr(tag_out),
                              len(tag_out), _ptr(tag_lens))
        if r < 0:
            raise FormatError("native tag pack buffer overflow")
        return r

    # the C calls release the GIL (plain ctypes), so the five independent
    # channel encodes run on five cores
    with ThreadPoolExecutor(max_workers=5) as ex:
        f_del = ex.submit(channel, q.streams[DEL], coding.del_scheme,
                          coding.drun_scheme, coding.del_char)
        f_ins = ex.submit(channel, ins_data, coding.ins_scheme)
        f_mrg = ex.submit(channel, mrg_data, coding.mrg_scheme)
        f_sub = ex.submit(channel, q.streams[SUB], coding.sub_scheme,
                          coding.srun_scheme, coding.sub_char)
        f_tag = ex.submit(tag_job)
        parts = [f_del.result(), None, f_ins.result(), f_mrg.result(),
                 f_sub.result()]
        parts[1] = (tag_out[: int(f_tag.result())], tag_lens)
    return dq.assemble_dexqv(coding, q.wells, q.begs, q.ends, q.qvs, parts)


def _step_parts(step_out, n: int):
    """qv_encode_step outputs -> the five (flat u8, per-entry byte lengths)
    parts of entries [0, n); rows past n are shape padding.  Only the
    words up to the widest row's raw count leave the device."""
    words, raw, out, dup, zext, packed, clens = step_out
    raw = raw.cpu().numpy()
    m = max(int(raw.max(initial=0)), 1)
    words = words[:, :, :m].cpu().numpy().view(np.uint32)
    out, dup, zext, packed, clens = (x.cpu().numpy()
                                     for x in (out, dup, zext, packed, clens))
    chans = []
    for c in range(4):
        f, w = bt.finalize_rows(words[c], raw[c], out[c], dup[c], zext[c])
        chans.append((f.view(np.uint8), 4 * w[:n]))
    tag_lens = (clens.astype(np.int64) + 3) >> 2
    tag = (rows_to_flat(packed, tag_lens), tag_lens[:n])
    return [chans[0], tag, chans[1], chans[2], chans[3]]


def assemble_from_step(step_out, coding: dq.QVCoding, wells, begs, ends,
                       qvs, n: int) -> bytes:
    """Build the .dexqv container from one qv_encode_step's outputs over
    all n entries (rows beyond ``n`` are shape padding)."""
    return dq.assemble_dexqv(coding, wells, begs, ends, qvs,
                             _step_parts(step_out, n))


def encode_buckets(lengths: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """The device encode's buckets of entries: [(rectangle width, entry
    indices)], one per quarter-octave row-length bucket
    (formats/ragged.bucket_len), in order of width.  A rectangle is as wide
    as the JAX package makes it: the bucket's longest read padded by
    ``pad_rows(align=512, bucket=True)``, and at least the bucket's width;
    so the step routes every bucket as the JAX package does
    (``emit.fused_ok``: K1/K2 up to 8,192 symbols, K9/K8 past it)."""
    lengths = np.asarray(lengths, np.int64)
    kb = np.array([bucket_len(max(int(L), 1), 512) for L in lengths], np.int64)
    out = []
    for width in np.unique(kb):
        sel = np.flatnonzero(kb == width)
        out.append((max(padded_width(lengths[sel], 512, bucket=True), int(width)), sel))
    return out


def bucket_rect(q: qv.QuivaFile, sel: np.ndarray, width: int, lossy: bool):
    """The five streams of entries ``sel`` as one (5, n_pad, width) u8
    rectangle and their (n_pad,) i32 lengths, the rows padded to
    ``bucket_rows``; lossy quantises insQV and mrgQV (QV.c:1049-1065)."""
    off = np.zeros(q.n_entries + 1, np.int64)
    np.cumsum(q.lengths, out=off[1:])
    lens = q.lengths[sel].astype(np.int64)
    idx = np.concatenate([np.arange(off[i], off[i + 1]) for i in sel])
    flat = q.streams[:, idx]
    if lossy:
        flat[INS] &= 0xFE
        flat[MRG] &= 0xFC
    rect = np.zeros((5, bucket_rows(len(sel)), width), np.uint8)
    for s in range(5):
        rect[s, :len(sel)] = pad_rows(flat[s], lens, align=width)
    lengths = np.zeros(rect.shape[1], np.int32)
    lengths[:len(sel)] = lens
    return rect, lengths


def _encode_entries_device(q: qv.QuivaFile, coding: dq.QVCoding, lossy: bool,
                           device: torch.device) -> bytes:
    """Encode all entries as batched device steps, one per bucket of
    ``encode_buckets``, so no row pads to the longest read's width;
    per-channel outputs scatter back to entry order through the native
    ragged copy."""
    n = q.n_entries
    sym, run, rchars, nlut, run_on = step_tables(coding)
    tables = [torch.as_tensor(x).to(device) for x in (sym, run, rchars, nlut)]

    chunks = [[] for _ in range(5)]
    for width, sel in encode_buckets(q.lengths):
        with stage("device: rects"):
            rect, lengths = bucket_rect(q, sel, width, lossy)
        with stage("device: step+finalize"):
            step_out = qv_encode_step(torch.from_numpy(rect).to(device),
                                      torch.from_numpy(lengths).to(device),
                                      *tables, run_on=run_on)
            for c, part in enumerate(_step_parts(step_out, len(sel))):
                chunks[c].append((sel, *part))

    def entry_order(chs):
        """Bucket-order channel chunks -> (flat, per-entry lens) in entry
        order (one native ragged memcpy per bucket)."""
        lens_full = np.zeros(n, np.int64)
        for sel, flat, lens in chs:
            # device-computed lengths feed unchecked native memcpys; turn an
            # inconsistent batch into an error instead of heap corruption
            if (np.asarray(lens) < 0).any() or int(lens.sum()) != len(flat):
                raise FormatError(
                    "device encode produced inconsistent stream lengths")
            lens_full[sel] = lens
        offs_full = np.zeros(n, np.int64)
        np.cumsum(lens_full[:-1], out=offs_full[1:])
        out = np.empty(int(lens_full.sum()), np.uint8)
        try:
            lib = qv_encode_shim()
        except OSError:                  # one slice copy per entry instead
            for sel, flat, lens in chs:
                src = 0
                for i, e in enumerate(sel):
                    n_b = int(lens[i])
                    out[offs_full[e]:offs_full[e] + n_b] = flat[src:src + n_b]
                    src += n_b
            return out, lens_full
        for sel, flat, lens in chs:
            lib.dxt_ragged_copy(
                _ptr(out), _ptr(np.ascontiguousarray(offs_full[sel])),
                _ptr(np.ascontiguousarray(flat)),
                _ptr(np.ascontiguousarray(lens.astype(np.int64))), len(sel))
        return out, lens_full

    with stage("device: order+assemble"):
        parts = [entry_order(ch) for ch in chunks]
        return dq.assemble_dexqv(coding, q.wells, q.begs, q.ends, q.qvs, parts)


# ---------------------------------------------------------------------------
# .dexqv -> .quiva decode
# ---------------------------------------------------------------------------

def _walk_tables(coding: dq.QVCoding):
    """The schemes as the native walker takes them: (lookups (S, 65536)
    i32, code lengths (S, 256) u8, types (S,) u8, scheme ids (6,) i32 of
    del, drun, ins, mrg, sub, srun with -1 for an absent run scheme)."""
    schemes = []

    def sidx(s):
        if s is None:
            return -1
        s.with_lookup()
        schemes.append(s)
        return len(schemes) - 1

    sid = np.array([
        sidx(coding.del_scheme), sidx(coding.drun_scheme),
        sidx(coding.ins_scheme), sidx(coding.mrg_scheme),
        sidx(coding.sub_scheme), sidx(coding.srun_scheme)], np.int32)
    lookups = np.ascontiguousarray(
        np.stack([s.lookup for s in schemes]).astype(np.int32))
    lens = np.ascontiguousarray(
        np.stack([np.minimum(s.codelens, 255) for s in schemes]).astype(np.uint8))
    types = np.array([s.type for s in schemes], np.uint8)
    return lookups, lens, types, sid


def _rlens_args(rl):
    """The walker's last two arguments: the headerless mode's read lengths
    and their count, or (None, 0) to parse entry headers."""
    return (None, 0) if rl is None else (_ptr(rl), len(rl))


def _rlens_i64(rlens):
    return None if rlens is None else np.ascontiguousarray(np.asarray(rlens, np.int64))


def _index_native(data: bytes, coding: dq.QVCoding, off: int, newv: bool,
                  rlens=None):
    """Lens-only native walk: resolve the bit-serial entry chain without
    materialising any stream (QV.c:1381-1426: every stream's byte length is
    known only after decoding it).  Returns (wells, begs, ends, qvs, entry
    offsets, entry lengths, channel offsets (ne, 5), run-token counts
    (ne, 2)), or None when the walker's shim cannot build.

    ``rlens``: headerless mode for a Dazzler DB's .qvs payload (DB.c:2575-2621:
    butted five-stream entries whose read lengths are in the .idx); the walk
    takes these lengths instead of parsing entry headers."""
    try:
        lib = qv_decode_shim()
    except OSError:
        return None
    lookups, lens, types, sid = _walk_tables(coding)
    buf = np.frombuffer(data, np.uint8)
    rl = _rlens_i64(rlens)
    cap = max(len(rl), 1) if rl is not None else max(len(buf) // (13 if newv else 7) + 2, 16)
    wells, begs, ends_, qvs = (np.zeros(cap, np.int32) for _ in range(4))
    eoffs, elens = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    coffs = np.zeros(5 * cap, np.int32)
    ntoks = np.zeros(2 * cap, np.int32)
    ne = lib.dxt_qv_walk(
        _ptr(buf), len(buf), off, _ptr(lookups), _ptr(lens), _ptr(types),
        _ptr(sid), coding.del_char, coding.sub_char, int(newv), cap, 1 << 62,
        _ptr(wells), _ptr(begs), _ptr(ends_), _ptr(qvs), _ptr(eoffs),
        _ptr(elens), None, 0, _ptr(coffs), _ptr(ntoks),
        0, 0, None, None, None, None, *_rlens_args(rl))
    if ne < 0:
        raise FormatError(f"corrupt .dexqv stream (native walker: {ne})")
    ne = int(ne)
    return (wells[:ne], begs[:ne], ends_[:ne], qvs[:ne], eoffs[:ne],
            elens[:ne], coffs[: 5 * ne].reshape(ne, 5),
            ntoks[: 2 * ne].reshape(ne, 2))


SEG_DECODE = 2048


def _index_checkpoints(data: bytes, coding: dq.QVCoding, off: int, newv: bool,
                       elens: np.ndarray, seg: int = SEG_DECODE, rlens=None):
    """Second lens-only native walk recording per-channel segment
    checkpoints every ``seg`` symbols (bit offsets, run-literal ranks and
    run carries), so that long reads decode as many short chains
    (qv_batch.fused_decode_entries_seg).  ``elens`` are the entry lengths
    of the first walk; ``rlens`` the headerless mode of ``_index_native``.
    Returns (seg, ck_offs (ne+1,) i64, ckb (4, B) i32, ckt (2, B) i32, ckc
    (2, B) i32), or None when no read crosses ``seg``."""
    ne = len(elens)
    nb = np.maximum((np.asarray(elens, np.int64) + seg - 1) // seg - 1, 0)
    btot = int(nb.sum())
    if btot == 0:
        return None
    ck_offs = np.zeros(ne + 1, np.int64)
    np.cumsum(nb, out=ck_offs[1:])
    ckb = np.zeros(4 * btot, np.int32)
    ckt = np.zeros(2 * btot, np.int32)
    ckc = np.full(2 * btot, -1, np.int32)
    lib = qv_decode_shim()
    lookups, lens, types, sid = _walk_tables(coding)
    buf = np.frombuffer(data, np.uint8)
    wells, begs, ends_, qvs = (np.zeros(ne, np.int32) for _ in range(4))
    eoffs, elens2 = np.zeros(ne, np.int64), np.zeros(ne, np.int64)
    rl = _rlens_i64(rlens)
    ne2 = lib.dxt_qv_walk(
        _ptr(buf), len(buf), off, _ptr(lookups), _ptr(lens), _ptr(types),
        _ptr(sid), coding.del_char, coding.sub_char, int(newv), ne, 1 << 62,
        _ptr(wells), _ptr(begs), _ptr(ends_), _ptr(qvs), _ptr(eoffs),
        _ptr(elens2), None, 0, None, None,
        seg, btot, _ptr(ck_offs), _ptr(ckb), _ptr(ckt), _ptr(ckc), *_rlens_args(rl))
    if int(ne2) != ne:
        raise FormatError("checkpoint walk entry-count mismatch")
    return seg, ck_offs, ckb.reshape(4, btot), ckt.reshape(2, btot), ckc.reshape(2, btot)


def _walk_native(data: bytes, coding: dq.QVCoding, off: int, newv: bool):
    """Decode all entries with the native sequential walker.  Returns
    (wells, begs, ends, qvs, lengths, streams (5, total) u8), or None when
    its shim cannot build.

    One materialising pass: the output capacity is estimated and doubled on
    overflow (walker rc -3)."""
    try:
        lib = qv_decode_shim()
    except OSError:
        return None
    lookups, lens, types, sid = _walk_tables(coding)
    buf = np.frombuffer(data, np.uint8)
    size = len(buf)
    cap_entries = max(size // (13 if newv else 7) + 2, 16)
    wells, begs, ends_, qvs = (np.zeros(cap_entries, np.int32) for _ in range(4))
    eoffs, elens = np.zeros(cap_entries, np.int64), np.zeros(cap_entries, np.int64)
    cap_total = max(size, 1 << 20)
    # an RLE escape token (>= 32 bits) expands to at most 65535 symbols, so
    # a stream byte never decodes to more than ~16K symbols: header fields
    # claiming more are corrupt, not large
    cap_limit = max(16384 * size, 1 << 20)
    while True:
        out = np.empty(5 * cap_total, np.uint8)
        ne = lib.dxt_qv_walk(
            _ptr(buf), size, off, _ptr(lookups), _ptr(lens), _ptr(types),
            _ptr(sid), coding.del_char, coding.sub_char, int(newv),
            cap_entries, cap_total,
            _ptr(wells), _ptr(begs), _ptr(ends_), _ptr(qvs), _ptr(eoffs),
            _ptr(elens), _ptr(out), 1, None, None,
            0, 0, None, None, None, None, None, 0)
        if ne == -3:
            if cap_total >= cap_limit:
                raise FormatError("corrupt .dexqv stream: entry lengths exceed "
                                  "what the stream could encode")
            cap_total = min(cap_total * 2, cap_limit)
            continue
        if ne < 0:
            raise FormatError(f"corrupt .dexqv stream (native walker: {ne})")
        break
    ne = int(ne)
    total = int(elens[:ne].sum())
    streams = out.reshape(5, cap_total)[:, :total]
    return wells[:ne], begs[:ne], ends_[:ne], qvs[:ne], elens[:ne], streams


def _decode_entries_device(data: bytes, coding: dq.QVCoding, off: int,
                           newv: bool, device: torch.device, mesh=None):
    """Raw-container batch decode: the native lens walk resolves the entry
    chain (offsets only), then every entry's five streams decode as
    independent chains on ``device``, or over the shards of ``mesh``
    (undexqv.c:101-208 output).  When a
    read crosses SEG_DECODE symbols, a second lens walk records checkpoints
    and every read decodes as chains of at most SEG_DECODE symbols
    (qv_batch.fused_decode_entries_seg); otherwise, or with the environment
    variable DXT_SEG_DECODE=0, every read is one chain per channel
    (qv_batch.fused_decode_entries), as in the JAX package.  None when the
    lens walk's shim cannot build."""
    from .qv_batch import fused_decode_entries, fused_decode_entries_seg

    with stage("index walk", len(data)):
        idx = _index_native(data, coding, off, newv)
    if idx is None:
        return None
    wells, begs, ends_, qvs, eoffs, elens, coffs, ntoks = idx
    ck = None
    if os.environ.get("DXT_SEG_DECODE", "1") == "1":
        with stage("checkpoint walk", len(data)):
            ck = _index_checkpoints(data, coding, off, newv, elens)
    buf = np.frombuffer(data, np.uint8)
    if ck is not None:
        rows = fused_decode_entries_seg(buf, eoffs, elens.astype(np.int32), coffs,
                                        ntoks, coding, ck, device, mesh)
    else:
        rows = fused_decode_entries(buf, eoffs, elens.astype(np.int32), coffs, ntoks,
                                    coding, device, mesh)
    rlens = elens.astype(np.int64)
    with stage("D2H+flat"):
        streams = np.stack([rows_to_flat(rows[s], rlens) for s in range(5)])
    return wells, begs, ends_, qvs, rlens, streams


def decode_entry(coding: dq.QVCoding, buf: np.ndarray, byte_off: int, rlen: int):
    """Uncompress_Next_QVentry (QV.c:1428-1481): decode 5 streams.

    Returns (streams (5, rlen) u8, bytes_consumed).
    """
    out = np.empty((5, rlen), np.uint8)
    pos = byte_off
    flip = coding.flip

    rd = bs.BitReader(buf, pos, flip)
    if coding.del_char < 0:
        out[DEL], words = bs.decode_stream(coding.del_scheme, rd, rlen)
        clen = rlen
    else:
        out[DEL], words = bs.decode_run_stream(coding.del_scheme, coding.drun_scheme,
                                               rd, rlen, coding.del_char)
        clen = int((out[DEL] != coding.del_char).sum())   # Packed_Length
    pos += 4 * words

    tlen = (clen + 3) >> 2
    if pos + tlen > len(buf):
        raise FormatError("could not read deletions entry")
    packed = buf[pos: pos + tlen]
    pos += tlen
    kept = tb.LOWER_LUT[tb.unpack_2bit_np(packed[None, :])[0, :clen]]
    if coding.del_char < 0:
        out[TAG] = kept
    else:                                                 # Unpack_Tag (QV.c:837-847)
        mask = out[DEL] != coding.del_char
        tag = np.full(rlen, ord("n"), np.uint8)
        tag[mask] = kept
        out[TAG] = tag

    rd = bs.BitReader(buf, pos, flip)
    out[INS], words = bs.decode_stream(coding.ins_scheme, rd, rlen)
    pos += 4 * words
    rd = bs.BitReader(buf, pos, flip)
    out[MRG], words = bs.decode_stream(coding.mrg_scheme, rd, rlen)
    pos += 4 * words
    rd = bs.BitReader(buf, pos, flip)
    if coding.sub_char < 0:
        out[SUB], words = bs.decode_stream(coding.sub_scheme, rd, rlen)
    else:
        out[SUB], words = bs.decode_run_stream(coding.sub_scheme, coding.srun_scheme,
                                               rd, rlen, coding.sub_char)
    pos += 4 * words
    return out, pos - byte_off


def _walk_python(data: bytes, coding: dq.QVCoding, off: int, newv: bool):
    """Decode all entries with the Python walker (``decode_entry``), the
    decoder of a container written on a host of the other byte order: its
    header fields and stream words are read byte-swapped.  Returns (wells,
    begs, ends, qvs, lengths, streams (5, total) u8)."""
    buf = np.frombuffer(data, np.uint8)
    mv = memoryview(data)
    size = len(buf)
    wells, begs, ends_, qvs, lengths, parts = [], [], [], [], [], []
    well = 0
    fmt = struct.Struct((">" if coding.flip else "<") + ("iii" if newv else "3H"))
    while off < size:
        b = buf[off]
        off += 1
        while b == 255:
            well += 255
            if off >= size:
                raise FormatError("truncated .dexqv (well escape)")
            b = buf[off]
            off += 1
        well += int(b)
        if off + fmt.size > size:
            raise FormatError("truncated .dexqv (fields)")
        beg, endp, q_ = fmt.unpack_from(mv, off)
        off += fmt.size
        rlen = endp - beg
        entry, consumed = decode_entry(coding, buf, off, rlen)
        off += consumed
        wells.append(well)
        begs.append(beg)
        ends_.append(endp)
        qvs.append(q_)
        lengths.append(rlen)
        parts.append(entry)
    streams = np.concatenate(parts, axis=1) if parts else np.empty((5, 0), np.uint8)
    return (np.array(wells), np.array(begs), np.array(ends_), np.array(qvs),
            np.array(lengths, np.int64), streams)


def decode_dexqv_to_quiva(data: bytes, upper: bool = False, device=None,
                          mesh=None) -> bytes:
    """Decode a .dexqv image to .quiva text (undexqv.c:101-208).

    device=False -> the native sequential walker on the host;
    device=True  -> entry boundaries by the native lens walk, stream content
                    by the batched decode on the CUDA device (raises without
                    one);
    "cpu" / "cuda" / a torch.device -> the batched decode there ("cpu" runs
                    the kernels' plain twins);
    device=None  -> utils/dispatch.device_default(), as the encoder.
    With ``mesh`` (parallel/mesh.py) the batched decode is split over its
    shards on the mesh's device: ``device`` None takes it, and a device
    that disagrees with the mesh (``False`` among them) raises.
    ``upper`` writes the delTag in upper case (-U).  As in the JAX package,
    a mode whose native shim cannot build falls back: the device decode
    (which needs the native lens walk) to the native walker, and that to
    the Python walker (``_walk_python``).  A container written on a host of
    the other byte order (``coding.flip``) decodes on the Python walker
    whatever ``device`` says: the native walker and the device chains read
    little-endian words only.  A CUDA request without CUDA still raises.
    """
    if len(data) < 2:
        raise FormatError("not a .dexqv file (empty or truncated)")
    with stage("tables", len(data)):
        mv = memoryview(data)
        (key,) = struct.unpack_from("<H", mv, 0)
        newv = key in (dq.CONTAINER_KEY, 0xAA55)
        coding, off = dq.parse_qvcoding(mv, 2 if newv else 0)  # legacy: no key
    if mesh is None:
        dev = resolve_device(device)
    elif device is False:
        raise ValueError("device=False asks for the host walker, a mesh for the device")
    else:
        dev = check_device(mesh, None if device is None else resolve_device(device))
    res = None
    if dev is not None and not coding.flip:
        res = _decode_entries_device(data, coding, off, newv, dev, mesh)
    if res is None and not coding.flip:
        with stage("decode", len(data)):
            res = _walk_native(data, coding, off, newv)
    if res is None:
        with stage("decode (Python walker)", len(data)):
            res = _walk_python(data, coding, off, newv)
    wells, begs, ends_, qvs, lengths, streams = res
    if upper:                                             # undexqv.c:198-204
        streams = streams.copy()
        streams[TAG] = streams[TAG] - 32
    with stage("assemble", int(np.asarray(lengths).sum()) * 5):
        return qv.write_quiva(coding.prefix, wells, begs, ends_, qvs, lengths,
                              streams)
