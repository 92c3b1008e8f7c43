"""The single-device five-channel encode step
(``dextractor_tpu/parallel/pipeline.py``).

``qv_encode_step`` encodes the five QV channels of a batch of entries.  The
four QV channels take one of two routes, chosen by the row width with the
JAX package's rule (``ops.emit.fused_ok``): ``channels_fused``, the plain
channels through K1 (ops.emit.encode_plain) and the RLE channels through K2
(ops.emit.encode_run), or ``channels_emissions``, the emission planes in
plain PyTorch with all their table lookups in one K9 launch
(ops.lut.lut_gather_groups) and the packing through K8
(ops.lut.pack_words).  The delTag channel goes
through K3 (ops.emit.pack_tags) on both routes.  On the CPU each wrapper
takes its kernel's plain twin; ``_pack_tags`` here is K3's twin.  The
sharded functions of the JAX module wait for the multi-GPU port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bitstream_torch as bt
from ..ops import emit
from ..ops import lut
from ..utils import dispatch

PLANE = (0, 2, 3, 4)   # channel c (del/ins/mrg/sub LUT order) -> its stream plane


def null_run_luts() -> np.ndarray:
    """A packed run-LUT that emits zero bits for every run length: with
    rchar = -1 every valid position is a literal and its run vanishes."""
    return np.zeros(256, np.int32)


def _as(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def _split(run_on):
    """(run channels, plain channels) in del/ins/mrg/sub LUT order."""
    run_cs = [c for c, on in ((0, run_on[0]), (3, run_on[1])) if on]
    return run_cs, [c for c in range(4) if c not in run_cs]


def _mix(run_cs, plain_cs, r, p):
    """Per-channel (words, t, lg) of the run and the plain channels ->
    words (4, N, W), t (4, N), lg (4, N) in channel order; the narrower
    plain word rows are zero-padded to the run rows' width."""
    width = r[0].shape[2] if run_cs else p[0].shape[2]
    parts = {}
    for j, c in enumerate(run_cs):
        parts[c] = (r[0][j], r[1][j], r[2][j])
    for j, c in enumerate(plain_cs):
        parts[c] = (F.pad(p[0][j], (0, width - p[0].shape[2])), p[1][j], p[2][j])
    return tuple(torch.stack([parts[c][i] for c in range(4)]) for i in range(3))


def channels_fused(streams, lengths, sym_luts, run_luts, rchars, run_on):
    """The four QV channels through K1 (plain) and K2 (RLE): words (4, N,
    W), t (4, N), lg (4, N), with W = 2L+2 when a channel is RLE, L+1
    otherwise.  Arguments as qv_encode_step's, as tensors on one device."""
    run_cs, plain_cs = _split(run_on)

    def rows(cs):
        return torch.stack([streams[PLANE[c]] for c in cs])

    p = emit.encode_plain(rows(plain_cs), lengths, sym_luts[plain_cs].contiguous())
    r = None
    if run_cs:
        r = emit.encode_run(rows(run_cs), lengths, sym_luts[run_cs].contiguous(),
                            run_luts[run_cs].contiguous(), rchars[run_cs].contiguous())
    return _mix(run_cs, plain_cs, r, p)


def channels_emissions(streams, lengths, sym_luts, run_luts, rchars, run_on):
    """The four QV channels as emission planes (the JAX package's
    non-fused branch, ``pipeline.py:131-176``): the runs of the RLE
    channels (``run_setup``), then one K9 launch for every table lookup of
    the bucket (the four symbol planes, read from ``streams`` in place, and
    the RLE channels' run planes), then per channel ``plain_emissions`` or
    ``run_assemble``, then one K8 launch per slot width, the channels folded
    into its rows.  Returns what ``channels_fused`` returns, of the same
    shapes."""
    run_cs, plain_cs = _split(run_on)

    def pack(parts):
        """[(v, n, t, lg)] of C channels -> words (C, N, M+1), t, lg."""
        v, n, t, lg = (torch.stack(x) for x in zip(*parts))
        c, rows, m = v.shape
        words = bt.pack_words_any(v.reshape(c * rows, m), n.reshape(c * rows, m))
        return words.reshape(c, rows, m + 1), t.to(torch.int32), lg.to(torch.int32)

    planes = [streams[PLANE[c]] for c in range(4)]
    setups = [bt.run_setup(planes[c], lengths, rchars[c].long()) for c in run_cs]
    entries = lut.lut_gather_groups(
        [(planes[c], c) for c in range(4)]
        + [(s.index, 4 + j) for j, s in enumerate(setups)],
        torch.cat([sym_luts, run_luts[run_cs]]))
    p = pack([bt.plain_emissions(planes[c], lengths, entries[c]) for c in plain_cs])
    r = None
    if run_cs:
        r = pack([bt.run_assemble(planes[c], s, entries[c], entries[4 + j], run_luts[c])
                  for j, (c, s) in enumerate(zip(run_cs, setups))])
    return _mix(run_cs, plain_cs, r, p)


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
                K1 or its plain emissions; the default sends both through
                the RLE encode, which is always correct.

    Rows of a width that ``emit.fused_ok`` accepts take ``channels_fused``
    (K1/K2), the others ``channels_emissions`` (K9/K8).  The step runs where
    ``streams`` lies: on its device when it is a tensor, on the CPU when it
    is a numpy array; the other arguments are moved there.  Returns (words
    (4, N, W) i32 u32-bit-patterns, raw (4, N), out (4, N), dup (4, N)
    bool, zext (4, N) bool, packed_tags (N, ceil(L/4)) u8, tag_clens (N,)
    i32), with W = 2L+2 when a channel is RLE and L+1 otherwise.  Word rows
    are valid up to raw.
    """
    device = streams.device if isinstance(streams, torch.Tensor) else torch.device("cpu")
    streams = _as(streams, torch.uint8, device)
    lengths = _as(lengths, torch.int32, device)
    sym_luts = _as(sym_luts, torch.int32, device)
    run_luts = _as(run_luts, torch.int32, device)
    rchars = _as(rchars, torch.int32, device)
    number_lut = _as(number_lut, torch.uint8, device)

    route = channels_fused if emit.fused_ok(streams.shape[2]) else channels_emissions
    words, t, lg = route(streams, lengths, sym_luts, run_luts, rchars, run_on)
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
