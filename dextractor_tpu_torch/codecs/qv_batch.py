"""Batched .dexqv entry decode on one device
(``dextractor_tpu/codecs/qv_batch.py``: the fused single-coding path).

A .dexqv entry is five butted Huffman streams (QV.c:1381-1426); once the
native lens walk has given every entry's offset, its channel offsets and
its run-token counts, the entries are N independent chains per channel.
The host slices each channel into a word-aligned rectangle (memcpy speed)
and ``ops/decode2.decode_entry_batch2`` decodes all five channels on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.ragged import bucket_len, next_pow2
from ..ops import decode2 as d2
from ..utils.profiling import stage


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
                         ntoks: np.ndarray, coding, device: torch.device):
    """Single-coding batch decode through ``decode_entry_batch2`` on
    ``device``: all five channels, run expansion and the delTag on the
    device, one launch set per span bucket, every read one chain per
    channel whatever its length.  Run chains are bounded by the lens walk's
    exact token counts.  Returns (5, N, max_len) u8 host rows, max_len the
    global quarter-octave bucket of the longest read."""
    rlens = np.asarray(rlens, np.int32)
    starts = np.asarray(starts, np.int64)
    coffs_a = np.asarray(coffs, np.int64)
    ntoks_a = np.asarray(ntoks)
    n = len(starts)
    gmax_len = bucket_len(int(rlens.max(initial=0)), 512)
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    f1_d = torch.from_numpy(f1).to(device)
    f2_d = torch.from_numpy(f2).to(device)

    def launch(sel):
        rl_b = rlens[sel]
        max_len = bucket_len(int(rl_b.max(initial=0)), 512)
        max_tokens = bucket_len(int(ntoks_a[sel].max(initial=0)), 16)
        with stage("rects"):
            rects = channel_rects(buf, starts[sel], coffs_a[sel], max_len)
            d = [torch.from_numpy(r.view(np.int32) if r.dtype == np.uint32 else r)
                 .to(device) for r in rects]
            rl_d = torch.from_numpy(rl_b).to(device)
        with stage("step"):
            rows = d2.decode_entry_batch2(
                *d, rl_d, sids, f1_d, f2_d, types, coding.del_char & 0xFF,
                coding.sub_char & 0xFF, max_len=max_len, max_tokens=max_tokens,
                del_mode=del_mode, sub_mode=sub_mode, subw=subw, lmax=lmax,
                chan_l2=chan_l2)
            if rows.device.type == "cuda":
                torch.cuda.synchronize(rows.device)
        with stage("D2H+flat"):
            return rows.cpu().numpy(), max_len

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
