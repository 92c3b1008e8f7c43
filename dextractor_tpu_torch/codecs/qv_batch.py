"""Batched .dexqv entry decode on the device, over a mesh of its shards
(``dextractor_tpu/codecs/qv_batch.py``).

A .dexqv entry is five butted Huffman streams (QV.c:1381-1426); once the
native lens walk has given every entry's offset, its channel offsets and
its run-token counts, the entries are N independent chains per channel.
The host slices each channel into a word-aligned rectangle (memcpy speed)
and ``ops/decode2.decode_entry_batch2`` decodes all five channels on the
device (``fused_decode_entries``: every read one chain per channel).

When a second lens walk has recorded checkpoints every ``seg`` symbols
(``qv_codec._index_checkpoints``), every read decodes instead as chains of
at most ``seg`` symbols, all live segments of all reads in one flat launch
set (``build_seg_launch_flat``, ``fused_decode_entries_seg``,
``ops/decode2.decode_entry_batch_seg``).  The JAX package's bucketed
segment layout (``DXT_SEG_FLAT=0``) is not ported: on the H100 it decoded
the same bytes slower than the flat layout on every corpus measured.

``batch_decode_entries`` is the per-scheme route of a Dazzler DB's QV load
(``db/access.py``), taken when no channel offsets can be had or with
``DXT_DB_FUSED=0``: it decodes from each entry's start alone, channel after
channel, the reads of each coding in one launch per rectangle width (K4b,
K5, K6), so a DB of several codings decodes in one call.

Every entry point takes ``device`` or ``mesh`` (parallel/mesh.py); a
device alone is a mesh of one shard on it.  The reads of every launch are
split over the mesh's shards (parallel/pipeline's sharded decodes; on the
per-scheme route the chains of each launch, as the JAX package's
``_conv_dispatch``), and the shards' rows come back in shard order to the
mesh's device before they are scattered and copied to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.ragged import bucket_len, next_pow2
from ..ops import decode2 as d2
from ..ops.decode_torch import decode_streams, stream_tables
from ..parallel.mesh import Mesh, check_device, make_mesh
from ..parallel.pipeline import sharded_decode_entry, sharded_decode_entry_seg
from ..utils.profiling import stage


def _mesh(device, mesh) -> Mesh:
    """The mesh a decode runs over: ``mesh`` (a ``device`` that disagrees
    raises), else one shard on ``device``."""
    if mesh is not None:
        check_device(mesh, device)
        return mesh
    if device is None:
        raise TypeError("a decode needs a device or a mesh")
    return make_mesh(1, device)


def _synchronize(mesh):
    for d in {mesh.devices[g] for g in mesh.local}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def decode_tables_v2(coding):
    """Coding -> two-level decode tables (ops/decode2.scheme_tables2).

    Returns (sids (6,) i32, f1 (S,256) i32, f2 flat i32, types (S,) i32,
    del_mode, sub_mode, subw, lmax)."""
    schemes = []

    def sidx(s):
        if s is None:
            return 0          # never dereferenced for absent run schemes
        schemes.append(s)
        return len(schemes) - 1

    sids = np.array([
        sidx(coding.del_scheme), sidx(coding.drun_scheme),
        sidx(coding.ins_scheme), sidx(coding.mrg_scheme),
        sidx(coding.sub_scheme), sidx(coding.srun_scheme)], np.int32)
    f1, f2, subw, lmax = d2.scheme_tables2(schemes)
    types = np.array([s.type for s in schemes], np.int32)
    del_mode = "run" if coding.del_char >= 0 else "plain"
    sub_mode = "run" if coding.sub_char >= 0 else "plain"
    return sids, f1, f2, types, del_mode, sub_mode, subw, lmax


def channel_rects(buf: np.ndarray, starts: np.ndarray, coffs: np.ndarray,
                  max_len: int):
    """Slice the five per-channel rectangles out of a container image.

    starts (N,) i64 entry stream offsets; coffs (N, 5) per-entry byte
    offsets of tag/ins/mrg/sub/end relative to the entry start (native lens
    walk).  Returns (rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub):
    chain rects are word-aligned (N, K) u32 with pow2-bucketed widths (+12
    words of slack), tag_bytes is (N, max_len//4) u8."""
    buf = np.asarray(buf, np.uint8)
    starts = np.asarray(starts, np.int64)
    coffs = np.asarray(coffs, np.int64)
    if len(starts) == 0:
        coffs = np.zeros((0, 5), np.int64)

    def chain_rect(beg, end):
        blen = int((end - beg).max(initial=0))
        k = next_pow2(((blen + 3) // 4) + 12)
        return d2.build_entry_rect(buf, starts + beg, k)

    zero = np.zeros(len(starts), np.int64)
    rect_del = chain_rect(zero, coffs[:, 0])
    rect_ins = chain_rect(coffs[:, 1], coffs[:, 2])
    rect_mrg = chain_rect(coffs[:, 2], coffs[:, 3])
    rect_sub = chain_rect(coffs[:, 3], coffs[:, 4])
    tb = max(max_len // 4, 1)
    idx = (starts + coffs[:, 0])[:, None] + np.arange(tb)
    tag_bytes = buf[np.minimum(idx, max(len(buf) - 1, 0))]
    return rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub


def span_buckets(coffs) -> np.ndarray:
    """Per-entry pow2 rect-width bucket key from the lens walk's channel
    offsets: the rect width the entry's widest channel needs (what
    channel_rects picks for a batch of just this entry).  Entries sharing a
    key decode in one launch."""
    coffs_a = np.asarray(coffs, np.int64)
    if len(coffs_a) == 0:
        return np.zeros(0, np.int64)
    spans = np.maximum.reduce([
        coffs_a[:, 0],
        coffs_a[:, 2] - coffs_a[:, 1],
        coffs_a[:, 3] - coffs_a[:, 2],
        coffs_a[:, 4] - coffs_a[:, 3]])
    return np.maximum(64, 2 ** np.ceil(
        np.log2(np.maximum(spans // 4 + 12, 1))).astype(np.int64))


def fused_decode_entries(buf: np.ndarray, starts: np.ndarray,
                         rlens: np.ndarray, coffs: np.ndarray,
                         ntoks: np.ndarray, coding, device=None, mesh=None):
    """Single-coding batch decode through ``decode_entry_batch2`` over the
    shards of ``mesh``, or on ``device`` alone
    (parallel/pipeline.sharded_decode_entry): all five channels, run
    expansion and the delTag on the device, one launch set per span bucket,
    every read one chain per channel whatever its length.  Run chains are
    bounded by the lens walk's exact token counts.  Returns (5, N, max_len)
    u8 host rows, max_len the global quarter-octave bucket of the longest
    read."""
    mesh = _mesh(device, mesh)
    rlens = np.asarray(rlens, np.int32)
    starts = np.asarray(starts, np.int64)
    coffs_a = np.asarray(coffs, np.int64)
    ntoks_a = np.asarray(ntoks)
    n = len(starts)
    gmax_len = bucket_len(int(rlens.max(initial=0)), 512)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    f1_d = torch.from_numpy(f1).to(mesh.device)
    f2_d = torch.from_numpy(f2).to(mesh.device)
    chars = (coding.del_char & 0xFF, coding.sub_char & 0xFF)

    def launch(sel):
        rl_b = rlens[sel]
        statics = dict(max_len=bucket_len(int(rl_b.max(initial=0)), 512),
                       max_tokens=bucket_len(int(ntoks_a[sel].max(initial=0)), 16),
                       del_mode=del_mode, sub_mode=sub_mode, subw=subw, lmax=lmax,
                       chan_l2=chan_l2)
        with stage("rects"):
            rects = channel_rects(buf, starts[sel], coffs_a[sel], statics["max_len"])
        with stage("step"):
            rows = sharded_decode_entry(mesh, **statics)(*rects, rl_b, sids, f1_d, f2_d,
                                                         types, *chars)
            _synchronize(mesh)
        with stage("D2H+flat"):
            return rows.cpu().numpy(), statics["max_len"]

    kws = span_buckets(coffs_a)
    uniq = np.unique(kws)
    if len(uniq) <= 1:
        return launch(np.arange(n))[0]
    out = np.zeros((5, n, gmax_len), np.uint8)
    for kw in uniq:
        sel = np.flatnonzero(kws == kw)
        rows, ml = launch(sel)
        out[:, sel, :ml] = rows
    return out


def build_seg_launch_flat(buf, starts, rlens, coffs, ntoks, coding, ck):
    """The arguments of one flat segmented launch over every live segment of
    every read (the JAX package's ``build_seg_launch_flat``): segment k of
    read r is a row of its own, decoding ``seg_rlens`` <= seg symbols from
    the read's checkpoint k (k >= 1; segment 0 starts at the stream's
    start), its stream ending at checkpoint k+1 of the same read or at the
    channel's end.  A read of length 0 keeps one row.

    Returns (args, statics, rid, kseg).  args = (rect_del, tag_in,
    rect_ins, rect_mrg, rect_sub, seg_rlens, pos0, carr) as numpy arrays:
    (NS, K_c) u32 segment rectangles sliced at each checkpoint's word,
    seg_rlens (NS,) i32, pos0 (4, NS) i32 bit offsets in [0, 32) of del,
    ins, mrg, sub, carr (2, NS) i32 run carries of del and sub (-1: start
    at a run code; >= 0: the checkpoint fell inside a run of that many
    more rchars).  tag_in is (NS, TB) u8 packed 2-bit delTag codes, code k
    of a row first in bits 7-6 of byte k >> 2: with delQV plain, the codes
    from the segment's first symbol on; with delQV RLE, the codes from the
    segment's first kept rank t0 on (the JAX package hands the same codes
    unpacked, as (NS, max_tokens) i32), realigned here when t0 % 4 != 0.
    statics holds decode_entry_batch_seg's keyword arguments seg (the row
    width ``seg_w``), max_tokens, del_mode and sub_mode; rid and kseg (NS,)
    map rows to (read, segment)."""
    seg, ck_offs, ckb, ckt, ckc = ck
    buf = np.asarray(buf, np.uint8)
    starts = np.asarray(starts, np.int64)
    coffs_a = np.asarray(coffs, np.int64)
    ntoks_a = np.asarray(ntoks)
    rl = np.asarray(rlens, np.int64)
    cko = np.asarray(ck_offs, np.int64)
    n = len(starts)
    btot = ckb.shape[1]
    segs_per = np.maximum(-(-rl // seg), 1)        # rl == 0 keeps one row
    ns = int(segs_per.sum())
    rid = np.repeat(np.arange(n), segs_per)
    base = np.zeros(n, np.int64)
    np.cumsum(segs_per[:-1], out=base[1:])
    kseg = np.arange(ns) - np.repeat(base, segs_per)
    live_ck = kseg >= 1                            # the row resumes mid-stream
    cidx = np.clip(cko[rid] + kseg - 1, 0, max(btot - 1, 0))
    seg_rlens = np.clip(rl[rid] - kseg * seg, 0, seg).astype(np.int32)
    seg_w = int(min(seg, bucket_len(int(seg_rlens.max(initial=1)), 512)))
    nxt_same = (kseg + 1) < segs_per[rid]          # the next row is the same read's

    chan_beg = np.stack([np.zeros(n, np.int64), coffs_a[:, 1], coffs_a[:, 2],
                         coffs_a[:, 3]])
    chan_end = np.stack([coffs_a[:, 0], coffs_a[:, 2], coffs_a[:, 3], coffs_a[:, 4]])
    rects, pos0 = [], []
    for c in range(4):
        bits = np.where(live_ck, ckb[c][cidx], 0).astype(np.int64)
        sbyte = starts[rid] + chan_beg[c][rid] + (bits >> 5) * 4
        bits_next = np.concatenate([bits[1:], np.zeros(1, np.int64)])
        end_bits = np.where(nxt_same, bits_next, (chan_end[c] - chan_beg[c])[rid] * 8)
        end_bits = np.maximum(end_bits, bits)
        span_w = ((end_bits - (bits & ~np.int64(31))) + 31) // 32
        kw = int(next_pow2(int(span_w.max(initial=1)) + 16))
        rects.append(d2.build_entry_rect(buf, sbyte, kw))
        pos0.append((bits & 31).astype(np.int32))
    pos0 = np.stack(pos0)

    del_run = coding.del_char >= 0
    sub_run = coding.sub_char >= 0
    carr = np.full((2, ns), -1, np.int32)
    if del_run:
        carr[0] = np.where(live_ck, ckc[0][cidx], -1)
    if sub_run:
        carr[1] = np.where(live_ck, ckc[1][cidx], -1)

    t0d = np.where(live_ck, ckt[0][cidx], 0).astype(np.int64)
    t0s = np.where(live_ck, ckt[1][cidx], 0).astype(np.int64)
    spans = []
    for t0, on, tk in ((t0d, del_run, 0), (t0s, sub_run, 1)):
        if not on:
            continue
        t0_next = np.concatenate([t0[1:], np.zeros(1, np.int64)])
        t1 = np.where(nxt_same, t0_next, ntoks_a[rid, tk])
        spans.append(int(np.maximum(t1 - t0, 0).max(initial=1)) + 2)
    max_tokens = bucket_len(max(spans, default=8), 16)

    tag_base = (starts + coffs_a[:, 0])[rid]
    last = max(len(buf) - 1, 0)
    if del_run:
        # code t0 + k at byte k >> 2 of the row: shift each byte pair left
        # by the 2-bit slot of t0 within its byte
        sh = (2 * (t0d & 3))[:, None]
        b0 = tag_base + (t0d >> 2)
        raw = buf[np.minimum(b0[:, None] + np.arange((max_tokens + 3) // 4 + 1),
                             last)].astype(np.int64)
        tag_in = (((raw[:, :-1] << sh) | (raw[:, 1:] >> (8 - sh))) & 0xFF).astype(np.uint8)
    else:
        tbw = max(seg_w // 4, 1)
        bidx = tag_base[:, None] + (kseg * (seg // 4))[:, None] + np.arange(tbw)
        tag_in = buf[np.minimum(bidx, last)]

    args = (rects[0], tag_in, rects[1], rects[2], rects[3], seg_rlens, pos0, carr)
    statics = dict(seg=seg_w, max_tokens=max_tokens,
                   del_mode="run" if del_run else "plain",
                   sub_mode="run" if sub_run else "plain")
    return args, statics, rid, kseg


def fused_decode_entries_seg(buf, starts, rlens, coffs, ntoks, coding, ck,
                             device=None, mesh=None):
    """Checkpoint-segmented batch decode over the shards of ``mesh``, or on
    ``device`` alone: every read runs as chains of at most ``seg`` symbols,
    all live segments in one flat launch set (``build_seg_launch_flat``,
    parallel/pipeline.sharded_decode_entry_seg,
    ``decode2.decode_entry_batch_seg``); the (5, NS, seg_w) segment rows
    are scattered to read rows by (read, segment) on the mesh's device.
    Returns (5, N, max_len) u8 host rows, max_len the quarter-octave bucket
    of the longest read."""
    mesh = _mesh(device, mesh)
    device = mesh.device
    rlens = np.asarray(rlens, np.int32)
    n = len(starts)
    gmax_len = bucket_len(int(rlens.max(initial=0)), 512)
    sids, f1, f2, types, _, _, subw, lmax = decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    seg = ck[0]
    with stage("rects"):
        args, statics, rid, kseg = build_seg_launch_flat(buf, starts, rlens, coffs,
                                                         ntoks, coding, ck)
        f1_d = torch.from_numpy(f1).to(device)
        f2_d = torch.from_numpy(f2).to(device)
        rid_d = torch.from_numpy(rid).to(device)
    with stage("step"):
        rows = sharded_decode_entry_seg(mesh, subw=subw, lmax=lmax, chan_l2=chan_l2,
                                        **statics)(
            *args, sids, f1_d, f2_d, types, coding.del_char & 0xFF, coding.sub_char & 0xFF)
        out = torch.zeros((5, n, gmax_len), dtype=torch.uint8, device=device)
        for k in np.unique(kseg):
            m = torch.from_numpy(np.flatnonzero(kseg == k)).to(device)
            w = min(rows.shape[2], gmax_len - int(k) * seg)
            out[:, rid_d[m], int(k) * seg:int(k) * seg + w] = rows[:, m, :w]
        _synchronize(mesh)
    with stage("D2H+flat"):
        return out.cpu().numpy()


def batch_decode_entries(buf: np.ndarray, starts: np.ndarray, rlens: np.ndarray,
                         codings, table: np.ndarray, ascii_mode: int = 1, *,
                         device=None, mesh=None):
    """Decode all five QV streams of N entries of several codings: the
    per-scheme route of the JAX package's ``batch_decode_entries``.

    buf (B,) u8 container image; starts (N,) byte offset of each entry's
    delQV stream; rlens (N,) symbols per entry; codings a list of
    QVCoding, table (N,) each entry's coding index.  Only ``starts`` is
    known: each later stream of an entry starts where the one before ends,
    by the encoder's word-count rule (``decode2.stream_word_counts``) on the
    chain's ``bits`` and ``last``, so the channels decode in turn, delQV,
    delTag, insQV, mergeQV, subQV.  In every channel the reads are grouped
    by coding (one scheme each) and by the pow2 width of the rectangle their
    entries' bytes need, one launch a group (``ops/decode_torch.decode_streams``,
    the launch path of the v1 decoders too): K4b (``decode_plain`` with C =
    1) for a plain channel, K5 (``decode_run``) and K6 (``expand_runs``) for
    an RLE one.  The delTag's packed bytes follow delQV: K6 places their
    letters beside delQV's literals, or, with delQV plain, they are unpacked
    in place.  The chains of every launch are split over the shards of
    ``mesh`` (one shard on ``device`` when no mesh is given), and their
    symbols or tokens come back in shard order to the mesh's device, where
    the rest runs.  On the CPU the wrappers run the kernels' plain twins.

    Returns (rows (5, N, max_len) u8 host rows, valid up to each entry's
    length, rlens (N,) i64); ``ascii_mode`` sets the delTag's letters (1
    lower case, 2 upper case, 0 the numeric codes 0-3)."""
    from ..ops import expand
    from ..ops import twobit as tb

    mesh = _mesh(device, mesh)
    device = mesh.device
    n = len(starts)
    rlens = np.asarray(rlens, np.int32)
    starts = np.asarray(starts, np.int64)
    max_len = bucket_len(int(rlens.max(initial=0)), 512)
    buf = np.concatenate([np.asarray(buf, np.uint8), np.zeros(8, np.uint8)])
    tbl = np.asarray(table, np.int64)

    schemes = []

    def sidx(s):
        if s is None:
            return -1
        schemes.append(s)
        return len(schemes) - 1

    # (del, drun, ins, mrg, sub, srun) scheme ids of each coding
    sids = np.array([[sidx(s) for s in (c.del_scheme, c.drun_scheme, c.ins_scheme,
                                        c.mrg_scheme, c.sub_scheme, c.srun_scheme)]
                     for c in codings], np.int64).reshape(len(codings), 6)
    for s in schemes:
        s.with_lookup()
    tables = stream_tables([s.lookup for s in schemes], [s.codelens for s in schemes],
                           [s.type for s in schemes], {mesh.devices[g] for g in mesh.local})
    # an entry's byte span (to the next entry's start) bounds each stream
    entry_ends = np.concatenate([starts[1:], [len(buf)]])
    out = torch.zeros((5, n, max_len), dtype=torch.uint8, device=device)

    def chains(chan, chan_starts):
        """Channel ``chan`` (0 del, 2 ins, 3 mrg, 4 sub) of every read,
        through ``decode_streams``: K4b for a plain stream, K5 for an RLE
        one, one launch a group of reads of one coding and rectangle width,
        over the shards of ``mesh``.  Yields, a group, (its reads, max_len,
        the symbol rows (n_g, max_len) u8 or the tokens (runs, lits), the run
        character or -1, the streams' u32 words (n_g,) i64 on the host)."""
        rchars = np.array([{0: c.del_char, 4: c.sub_char}.get(chan, -1) for c in codings])
        run_ids = np.where(rchars >= 0, sids[:, chan + 1], -1)[tbl]
        for sel, ml, got in decode_streams(
                mesh, buf, chan_starts, entry_ends - chan_starts, rlens,
                sids[tbl, chan], run_ids, tables,
                lambda sel: bucket_len(int(rlens[sel].max(initial=0)), 512)):
            rchar = int(rchars[tbl[sel[0]]])
            with stage("step"):
                words = d2.stream_word_counts(got[-2].cpu().numpy(), got[-1].cpu().numpy())
            yield sel, ml, (got[0] if rchar < 0 else tuple(got[:2])), rchar, words

    in_read = (torch.arange(max_len, device=device)[None, :]
               < torch.from_numpy(rlens).to(device)[:, None])
    # phase A: delQV, then the packed delTag after its last word, whose
    # length is the read's kept (non-delChar) symbols
    tag_starts = np.zeros(n, np.int64)
    clens = rlens.astype(np.int64)
    for sel, ml, got, rchar, words in chains(0, starts):
        tag_starts[sel] = starts[sel] + 4 * words
        with stage("rects"):
            idx = tag_starts[sel][:, None] + np.arange(max(ml // 4, 1))
            tag_b = torch.from_numpy(buf[np.minimum(idx, len(buf) - 1)]).to(device)
            idx = torch.from_numpy(sel).to(device)
        with stage("step"):
            inr = in_read[idx, :ml]
            if rchar < 0:
                rows = got
                tag_rows = d2._tag_letters(d2._unpack_tag_codes(tag_b, ml)).to(torch.uint8)
            else:
                rows, tags = expand.expand_runs(*got, rchar, max_len=ml, tag_bytes=tag_b)
                tag_rows = torch.where(tags >= 0, tags.to(torch.uint8),
                                       inr.to(torch.uint8) * ord("n"))
                clens[sel] = ((rows != rchar) & inr).sum(1).cpu().numpy()
            out[0, idx, :ml] = rows
            out[1, idx, :ml] = tag_rows
    # phases B-D: ins, mrg and sub, each starting where the one before ends
    chan_starts = tag_starts + ((clens + 3) >> 2)
    for chan in (2, 3, 4):
        nxt = np.zeros(n, np.int64)
        for sel, ml, got, rchar, words in chains(chan, chan_starts):
            with stage("step"):
                rows = got if rchar < 0 else expand.expand_runs(*got, rchar, max_len=ml)[0]
                out[chan, torch.from_numpy(sel).to(device), :ml] = rows
            nxt[sel] = chan_starts[sel] + 4 * words
        chan_starts = nxt
    with stage("step"):
        out = torch.where(in_read, out, 0)
        _synchronize(mesh)
    with stage("D2H+flat"):
        rows = out.cpu().numpy()
    if ascii_mode == 2:
        rows[1] = rows[1] - 32
    elif ascii_mode == 0:
        rows[1] = tb.NUMBER_BASE_LUT[rows[1]]
    return rows, rlens.astype(np.int64)
