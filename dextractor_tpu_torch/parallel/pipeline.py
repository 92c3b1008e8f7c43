"""The single-device five-channel encode step
(``dextractor_tpu/parallel/pipeline.py``).

``qv_encode_step`` encodes the five QV channels of a batch of entries: the
plain channels through K1 (ops.emit.encode_plain), the RLE channels through
K2 (ops.emit.encode_run), the delTag channel through K3
(ops.emit.pack_tags).  On the CPU each wrapper takes its kernel's plain
twin; ``_pack_tags`` here is K3's twin.  The sharded functions of the JAX
module wait for the multi-GPU port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bitstream_torch as bt
from ..ops import emit
from ..utils import dispatch


def null_run_luts() -> np.ndarray:
    """A packed run-LUT that emits zero bits for every run length: with
    rchar = -1 every valid position is a literal and its run vanishes."""
    return np.zeros(256, np.int32)


def _as(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def qv_encode_step(streams, lengths, sym_luts, run_luts, rchars, number_lut,
                   run_on=(True, True)):
    """Encode the five QV channels of a batch of entries on one device.

    streams:    (5, N, L) u8 — del, tag, ins, mrg, sub
    lengths:    (N,) i32
    sym_luts:   (4, 256) packed i32 — symbol LUTs for del, ins, mrg, sub
    run_luts:   (4, 256) packed i32 — run LUTs (null LUT for plain channels)
    rchars:     (4,) i32 — run char per channel (-1 for plain)
    number_lut: (256,) u8 — tag base numbering
    run_on:     (del_has_run_scheme, sub_has_run_scheme); a channel without
                a run scheme is a plain stream (QV.c:1393-1423) and goes to
                K1; the default sends both through K2, which is always
                correct.

    The step runs where ``streams`` lies: on its device when it is a
    tensor, on the CPU when it is a numpy array; the other arguments are
    moved there.  Returns (words (4, N, W) i32 u32-bit-patterns, raw
    (4, N), out (4, N), dup (4, N) bool, zext (4, N) bool, packed_tags
    (N, ceil(L/4)) u8, tag_clens (N,) i32), with W = 2L+2 when a channel
    runs through K2 and L+1 otherwise.  Word rows are valid up to raw.
    """
    device = streams.device if isinstance(streams, torch.Tensor) else torch.device("cpu")
    streams = _as(streams, torch.uint8, device)
    lengths = _as(lengths, torch.int32, device)
    sym_luts = _as(sym_luts, torch.int32, device)
    run_luts = _as(run_luts, torch.int32, device)
    rchars = _as(rchars, torch.int32, device)
    number_lut = _as(number_lut, torch.uint8, device)

    # channel c (del/ins/mrg/sub LUT order) -> its stream plane
    plane = (0, 2, 3, 4)
    run_cs = [c for c, on in ((0, run_on[0]), (3, run_on[1])) if on]
    plain_cs = [c for c in range(4) if c not in run_cs]

    def rows(cs):
        return torch.stack([streams[plane[c]] for c in cs])

    parts = {}
    p_words, p_t, p_lg = emit.encode_plain(rows(plain_cs), lengths,
                                           sym_luts[plain_cs].contiguous())
    width = p_words.shape[2]
    if run_cs:
        r_words, r_t, r_lg = emit.encode_run(
            rows(run_cs), lengths, sym_luts[run_cs].contiguous(),
            run_luts[run_cs].contiguous(), rchars[run_cs].contiguous())
        width = r_words.shape[2]
        for j, c in enumerate(run_cs):
            parts[c] = (r_words[j], r_t[j], r_lg[j])
    for j, c in enumerate(plain_cs):
        parts[c] = (F.pad(p_words[j], (0, width - p_words.shape[2])),
                    p_t[j], p_lg[j])
    words = torch.stack([parts[c][0] for c in range(4)])
    t = torch.stack([parts[c][1] for c in range(4)])
    lg = torch.stack([parts[c][2] for c in range(4)])
    raw, out, dup, zext = bt.word_counts(t, lg)

    packed, clens = emit.pack_tags(streams[1], streams[0], lengths,
                                   rchars[0:1].contiguous(), number_lut)
    return words, raw, out, dup, zext, packed, clens


def _pack_tags(tag_rows, del_rows, lengths, del_char, number_lut):
    """Plain twin of K3: Pack_Tag + Number_Read + Compress_Read, batched
    (QV.c:810-819).

    A tag is kept where delQV != delChar (every valid tag when delChar < 0);
    its rank among the kept tags of its row places its 2-bit code at byte
    rank >> 2, the first code in bits 7-6.  Returns (packed (N, ceil(L/4))
    u8, clens (N,) i32)."""
    dispatch.TWIN_CALLS["pack_tags"] += 1
    n, l = tag_rows.shape
    col = torch.arange(l, device=tag_rows.device)[None, :]
    valid = col < lengths.long().clamp(0, l)[:, None]
    dc = torch.as_tensor(del_char, device=tag_rows.device).long().reshape(())
    keep = valid & ((del_rows.long() != dc) | (dc < 0))
    codes = number_lut.long()[tag_rows.long()]
    rank = torch.cumsum(keep.long(), 1) - 1
    contrib = torch.where(keep, codes << (6 - 2 * (rank & 3)), 0)
    wb = (l + 3) // 4
    packed = torch.zeros((n, wb), dtype=torch.long, device=tag_rows.device)
    if l:
        packed.scatter_add_(1, rank.clamp(min=0) >> 2, contrib)
    return packed.to(torch.uint8), keep.sum(1).to(torch.int32)
