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
takes its kernel's plain twin; ``_pack_tags`` here is K3's twin.

The sharded pipeline runs the same steps over a mesh (parallel/mesh.py):

  phase A  ``sharded_scan_to_stats``: every shard histograms its block of
           entries (``qv_scan_step``, ``qv_run_hist_step``); the tables are
           summed over the mesh (``mesh.all_reduce``), so every process holds
           the file-global statistics (one Huffman table per file,
           QV.c:922-1023), and delChar is elected in file order;
  phase B  ``sharded_qv_encode``: every shard encodes its block with the
           shared tables through ``qv_encode_step``;
  decode   ``sharded_decode_entry`` and ``sharded_decode_entry_seg`` run
           ops/decode2's five-channel steps a shard,
           ``sharded_decode_plain``/``_run`` the v1 stream decoders of
           ops/decode_torch, and ``sharded_twobit_encode``/``_decode`` the
           2-bit ops of ops/twobit.

Each ``sharded_*`` function takes the mesh and returns a callable over
whole host arrays (numpy or tensors), as the JAX package's ``shard_map``s
do: the reads are split into the mesh's equal contiguous blocks
(``mesh.split``, zero-length reads as padding), each local shard's block
runs on its device in turn, and the outputs come back concatenated in
shard order on ``mesh.device``, cut to the real reads of this process's
shards (all reads for a mesh of one process).  The only collectives are
the scan's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bitstream_torch as bt
from ..ops import emit
from ..ops import lut
from ..utils import dispatch
from .mesh import all_reduce
from .multihost import mesh_put

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


# ---------------------------------------------------------------------------
# the scan steps of one shard (phase A)
# ---------------------------------------------------------------------------

I32_INF = 0x7FFFFFFF


def _histogram256(data, weights):
    """256-bin histogram of the u8 values of ``data`` where ``weights`` is
    true, in exact int64 counts.  ``torch.bincount``: the JAX package's
    one-hot MXU product (``pipeline.py:200``) is XLA, not a Pallas kernel."""
    return torch.bincount(data.reshape(-1)[weights.reshape(-1)].long(), minlength=256)


def _valid(rows, lengths):
    col = torch.arange(rows.shape[1], device=rows.device)
    return col[None, :] < lengths.long()[:, None]


def qv_scan_step(streams, lengths):
    """Statistics of one shard: the histograms of del, ins, mrg and sub
    (4, 256) i64, the total symbols, the first 'n'/'N' delTag's flat
    position in the shard (int32 range, I32_INF for none), its entry
    (I32_INF for none) and the delQV under it (the first minimum; garbage
    without an 'n').  The run histograms need delChar/subChar, which exist
    only after the global reduction: ``qv_run_hist_step``."""
    _, n, l = streams.shape
    dev = streams.device
    valid = _valid(streams[0], lengths)
    hists = torch.stack([_histogram256(streams[p], valid) for p in PLANE])
    tot = lengths.long().sum()
    tag = streams[1]
    isn = valid & ((tag == ord("n")) | (tag == ord("N")))
    starts = torch.cumsum(lengths.long(), 0) - lengths.long()
    col = torch.arange(l, device=dev)
    flatpos = torch.where(isn, col[None, :] + starts[:, None], I32_INF).to(torch.int32)
    if flatpos.numel() == 0:
        inf = torch.tensor(I32_INF, device=dev)
        return hists, tot, inf, inf, torch.tensor(0, device=dev)
    flat = flatpos.reshape(-1)
    first_n = flat.min().long()
    first_entry = torch.where(isn.any(1), torch.arange(n, device=dev), I32_INF).min()
    dcand = streams[0].reshape(-1)[flat.argmin()].long()
    return hists, tot, first_n, first_entry, dcand


def qv_run_hist_step(data, lengths, rchar):
    """Histogram_Runs over a shard (QV.c:702-724): before every literal the
    length of the run of ``rchar`` since the previous literal, and the
    trailing run of each row when it is not empty, each clamped at 255.
    The JAX package's ``associative_scan(max)`` is ``torch.cummax``."""
    n, l = data.shape
    if l == 0:
        return torch.zeros(256, dtype=torch.long, device=data.device)
    col = torch.arange(l, device=data.device).expand(n, l)
    is_lit = _valid(data, lengths) & (data.long() != int(rchar))
    run_max = torch.cummax(torch.where(is_lit, col, -1), 1).values
    prev_lit = torch.cat([torch.full((n, 1), -1, device=data.device), run_max[:, :-1]], 1)
    hist = _histogram256((col - prev_lit - 1).clamp(max=255), is_lit)
    trail = (lengths.long() - run_max[:, -1] - 1).clamp(min=0)
    return hist + _histogram256(trail.clamp(max=255), trail > 0)


def qv_subchar_prefix_step(sub_rows, lengths, upto_entry: int):
    """The substitution histogram of entries [0, upto_entry] of a shard:
    the prefix the subChar mode is chosen from (QV.c:1006-1017)."""
    w = _valid(sub_rows, lengths) & (torch.arange(sub_rows.shape[0], device=sub_rows.device)
                                    <= int(upto_entry))[:, None]
    return _histogram256(sub_rows, w)


# ---------------------------------------------------------------------------
# the sharded pipeline
# ---------------------------------------------------------------------------

def _on_devices(mesh, x, dtype):
    """One copy of the replicated array ``x`` on each device of this
    process's shards: {device: tensor}."""
    return {d: _as(x, dtype, d) for d in {mesh.devices[g] for g in mesh.local}}


def _gather(mesh, parts, n_real, axis: int = 0):
    """Per-shard outputs -> one tensor on ``mesh.device``, concatenated in
    shard order along ``axis`` and cut to the local shards' real rows."""
    out = torch.cat([p.to(mesh.device) for p in parts], axis)
    return out.narrow(axis, 0, n_real)


def _local_reads(mesh, n: int) -> int:
    """The real reads of this process's shards."""
    _, blocks = mesh.split(n)
    return sum(end - beg for _, beg, end in blocks)


def sharded_qv_scan(mesh):
    """Phase A's scan: (streams (5, N, L), lengths (N,)) -> (hists (4, 256),
    tot, winner, gentry, dchar), the same on every process.  Shards are
    contiguous read blocks in file order, so delChar is elected as the
    sequential scan finds it: ``winner`` is the lowest shard holding an 'n'
    tag (min over the mesh), then ``dchar`` and ``gentry`` (its local entry)
    come from that shard alone (max over the mesh of -1 elsewhere)."""
    put = mesh_put(mesh)

    def scan(streams, lengths):
        _, blocks = mesh.split(lengths.shape[0])
        res = [qv_scan_step(s, l) for s, l in zip(put(streams, 1, torch.uint8),
                                                  put(lengths, 0, torch.int32))]
        dev = mesh.device
        hists = all_reduce(mesh, [torch.cat([h.reshape(-1), t.reshape(1)])
                                  for h, t, *_ in res], "sum")
        has_n = [r[2].item() < I32_INF for r in res]
        winner = all_reduce(mesh, [torch.tensor(g if h else I32_INF, device=dev)
                                   for (g, _, _), h in zip(blocks, has_n)], "min")
        w = winner.item()
        mine = [g == w and h for (g, _, _), h in zip(blocks, has_n)]
        cand = all_reduce(mesh, [torch.stack([r[4], r[3]]) if m
                                 else torch.tensor([-1, -1], device=r[4].device)
                                 for r, m in zip(res, mine)], "max")
        return hists[:1024].reshape(4, 256), hists[1024], winner, cand[1], cand[0]

    return scan


def sharded_run_hist(mesh):
    """Histogram_Runs over the mesh: (data (N, L), lengths (N,), rchar) ->
    the (256,) sum over the shards of ``qv_run_hist_step``."""
    put = mesh_put(mesh)

    def run_hist(data, lengths, rchar):
        return all_reduce(mesh, [qv_run_hist_step(d, l, int(rchar)) for d, l in zip(
            put(data, 0, torch.uint8), put(lengths, 0, torch.int32))], "sum")

    return run_hist


def sharded_hist_masked(mesh):
    """The length-masked histogram over the mesh (the subChar prefix):
    (data (N, L), lengths (N,)) -> (256,)."""
    put = mesh_put(mesh)

    def hist(data, lengths):
        return all_reduce(mesh, [_histogram256(d, _valid(d, l)) for d, l in zip(
            put(data, 0, torch.uint8), put(lengths, 0, torch.int32))], "sum")

    return hist


def sharded_scan_to_stats(mesh, streams, lengths):
    """The whole phase-A scan over the mesh, with the sequential
    QVcoding_Scan's semantics (QV.c:922-1023): global histograms, delChar
    elected in file order, subChar the mode of the prefix up to the entry
    where the total passes 100,000 symbols, the run histograms from those
    entries on.  streams (5, N, L) u8 and lengths (N,), numpy or tensors,
    whole on every process.  Returns the port's codecs.qv_codec.QVStats."""
    from ..codecs.qv_codec import QVStats

    lengths_np = (lengths.cpu().numpy() if isinstance(lengths, torch.Tensor)
                  else np.asarray(lengths)).astype(np.int64)
    n = len(lengths_np)
    per, _ = mesh.split(n)
    hists, tot, winner, gentry, dchar = sharded_qv_scan(mesh)(streams, lengths_np)
    hists = hists.cpu().numpy().astype(np.int64)
    del_char = int(dchar)
    entry_idx = np.arange(n)

    del_run = np.ones(256, np.int64)
    if del_char >= 0:
        r0 = int(winner) * per + int(gentry)
        del_run += sharded_run_hist(mesh)(
            streams[0], np.where(entry_idx >= r0, lengths_np, 0), del_char).cpu().numpy()

    sub_run = np.ones(256, np.int64)
    sub_char = -1
    total = int(tot)
    if total >= 100000:
        r1 = int(np.searchsorted(np.cumsum(lengths_np), 100000, "left"))
        part = sharded_hist_masked(mesh)(streams[4], np.where(entry_idx <= r1, lengths_np, 0))
        sub_char = int(part.cpu().numpy().argmax())
        sub_run += sharded_run_hist(mesh)(
            streams[4], np.where(entry_idx >= r1, lengths_np, 0), sub_char).cpu().numpy()

    return QVStats(hists[0], hists[1], hists[2], hists[3], del_run, sub_run,
                   del_char, sub_char, total)


def sharded_qv_encode(mesh, run_on=(True, True)):
    """Phase B over the mesh: (streams (5, N, L), lengths (N,), sym_luts,
    run_luts, rchars, number_lut) -> ``qv_encode_step``'s seven outputs,
    concatenated over reads in shard order.  Every shard's block has the
    rectangle's global width L, so every shard takes the same route (K1/K2
    where ``emit.fused_ok(L)``, K9/K8 otherwise) and its words the same
    width."""
    put = mesh_put(mesh)

    def encode(streams, lengths, sym_luts, run_luts, rchars, number_lut):
        n = lengths.shape[0]
        tables = [_on_devices(mesh, x, t) for x, t in (
            (sym_luts, torch.int32), (run_luts, torch.int32), (rchars, torch.int32),
            (number_lut, torch.uint8))]
        parts = [qv_encode_step(s, l, *(t[s.device] for t in tables), run_on=run_on)
                 for s, l in zip(put(streams, 1, torch.uint8), put(lengths, 0, torch.int32))]
        m = _local_reads(mesh, n)
        return tuple(_gather(mesh, [p[i] for p in parts], m, 1 if i < 5 else 0)
                     for i in range(7))

    return encode


def sharded_decode_entry(mesh, *, max_len: int, max_tokens: int, del_mode: str,
                         sub_mode: str, subw: int, lmax: int, chan_l2: tuple | None = None):
    """The fused five-channel entry decode over the mesh: (rect_del,
    tag_bytes, rect_ins, rect_mrg, rect_sub, rlens, sids, f1, f2, types,
    del_char, sub_char) as ``ops/decode2.decode_entry_batch2`` takes them,
    the rectangles and rlens split into the mesh's blocks of reads, the
    tables on every shard's device.  Returns (5, N, max_len) u8 rows."""
    from ..ops import decode2 as d2
    put = mesh_put(mesh)

    def decode(rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub, rlens, sids, f1, f2,
               types, del_char, sub_char):
        f1d, f2d = _on_devices(mesh, f1, torch.int32), _on_devices(mesh, f2, torch.int32)
        rows = [put(x) for x in (rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub)]
        parts = [d2.decode_entry_batch2(
            *r, rl, sids, f1d[rl.device], f2d[rl.device], types, del_char, sub_char,
            max_len=max_len, max_tokens=max_tokens, del_mode=del_mode, sub_mode=sub_mode,
            subw=subw, lmax=lmax, chan_l2=chan_l2)
            for *r, rl in zip(*rows, put(rlens, 0, torch.int32))]
        return _gather(mesh, parts, _local_reads(mesh, len(rlens)), 1)

    return decode


def sharded_decode_entry_seg(mesh, *, seg: int, max_tokens: int, del_mode: str,
                             sub_mode: str, subw: int, lmax: int, chan_l2: tuple | None = None):
    """The checkpoint-segmented entry decode over the mesh: (rect_del,
    tag_in, rect_ins, rect_mrg, rect_sub, seg_rlens, pos0, carr, sids, f1,
    f2, types, del_char, sub_char) as ``ops/decode2.decode_entry_batch_seg``
    takes them, in the flat layout (codecs/qv_batch.build_seg_launch_flat;
    the JAX package's function takes its bucketed layout, which is not
    ported).  Every segment row is a chain of its own that starts at its
    checkpoint, so the rows split into the mesh's blocks as reads do.
    Returns (5, NS, seg) u8 segment rows."""
    from ..ops import decode2 as d2
    put = mesh_put(mesh)

    def decode(rect_del, tag_in, rect_ins, rect_mrg, rect_sub, seg_rlens, pos0, carr,
               sids, f1, f2, types, del_char, sub_char):
        f1d, f2d = _on_devices(mesh, f1, torch.int32), _on_devices(mesh, f2, torch.int32)
        rows = [put(x) for x in (rect_del, tag_in, rect_ins, rect_mrg, rect_sub)]
        parts = [d2.decode_entry_batch_seg(
            *r, rl, p, c, sids, f1d[rl.device], f2d[rl.device], types, del_char, sub_char,
            seg=seg, max_tokens=max_tokens, del_mode=del_mode, sub_mode=sub_mode,
            subw=subw, lmax=lmax, chan_l2=chan_l2)
            for *r, rl, p, c in zip(*rows, put(seg_rlens, 0, torch.int32),
                                    put(pos0, 1, torch.int32), put(carr, 1, torch.int32, -1))]
        return _gather(mesh, parts, _local_reads(mesh, len(seg_rlens)), 1)

    return decode


def sharded_decode_plain(mesh, *, max_len: int):
    """The v1 plain-stream decode over the mesh: (buf, starts, rlens,
    scheme_ids, lookups, lens_tbl, types) -> (symbols (N, max_len) u8,
    total_bits (N,) i32, last_gran (N,) i32), as
    ``ops/decode_torch.decode_plain_batch`` takes and returns them.  The
    image and the tables are replicated, the streams split into the mesh's
    blocks (zero-length streams as padding, so N need not be a multiple of
    the shard count), each block decoded on its shard's device (K4b), and
    the outputs gathered in shard order."""
    from ..ops.decode_torch import decode_plain_batch
    put = mesh_put(mesh)

    def decode(buf, starts, rlens, scheme_ids, lookups, lens_tbl, types):
        parts = [decode_plain_batch(buf, s, r, i, lookups, lens_tbl, types, max_len=max_len,
                                    device=r.device)
                 for s, r, i in zip(put(starts, 0, torch.int64), put(rlens, 0, torch.int32),
                                    put(scheme_ids, 0, torch.int32))]
        m = _local_reads(mesh, len(rlens))
        return tuple(_gather(mesh, [p[i] for p in parts], m) for i in range(3))

    return decode


def sharded_decode_run(mesh, *, max_tokens: int):
    """The v1 RLE-stream decode over the mesh: (buf, starts, rlens, sym_ids,
    run_ids, lookups, lens_tbl, types) -> (runs, lits, n_tokens,
    total_bits, last_gran), as ``ops/decode_torch.decode_run_batch`` takes
    and returns them, split and gathered as ``sharded_decode_plain`` (K5)."""
    from ..ops.decode_torch import decode_run_batch
    put = mesh_put(mesh)

    def decode(buf, starts, rlens, sym_ids, run_ids, lookups, lens_tbl, types):
        parts = [decode_run_batch(buf, s, r, i, j, lookups, lens_tbl, types,
                                  max_tokens=max_tokens, device=r.device)
                 for s, r, i, j in zip(put(starts, 0, torch.int64), put(rlens, 0, torch.int32),
                                       put(sym_ids, 0, torch.int32),
                                       put(run_ids, 0, torch.int32))]
        m = _local_reads(mesh, len(rlens))
        return tuple(_gather(mesh, [p[i] for p in parts], m) for i in range(5))

    return decode


def sharded_twobit_encode(mesh, alphabet: str | None = "base"):
    """The 2-bit pack over the mesh (the .dexta/.dexar compute path at
    scale): (ascii_rows (N, L), lengths (N,), number_lut (256,)) -> packed
    rows (N, ceil(L/4)) u8, first base in bits 7-6, bases at or past a
    row's length 0: the JAX package's ``pack_translate`` for the alphabets
    "base" and "arrow" (whose tables replace ``number_lut``), its
    ``pack_2bit(number_lut[rows])`` for None.  One K7 launch a shard
    (``ops/twobit.pack_rows``), no collective (Compress_Read is per read,
    DB.c:319-338)."""
    from ..ops import twobit as tb
    if alphabet is not None and alphabet not in tb.ALPHABET_LUTS:
        raise ValueError(f"unknown alphabet {alphabet!r}")
    put = mesh_put(mesh)

    def encode(ascii_rows, lengths, number_lut):
        lut = tb.ALPHABET_LUTS[alphabet] if alphabet else number_lut
        parts = [tb.pack_rows(r, l, lut) for r, l in zip(
            put(ascii_rows, 0, torch.uint8), put(lengths, 0, torch.int64))]
        return _gather(mesh, parts, _local_reads(mesh, len(lengths)))

    return encode


def sharded_twobit_decode(mesh):
    """The 2-bit unpack and letter map over the mesh: (packed_rows (N, C),
    letter_lut (4,)) -> (N, 4C) u8, every code of every byte as its letter
    (the JAX package's ``unpack_translate``, ``ops/twobit.unpack_translate``
    here).  One unpack launch a shard."""
    from ..ops import twobit as tb
    put = mesh_put(mesh)

    def decode(packed_rows, letter_lut):
        parts = [tb.unpack_translate(p, letter_lut) for p in put(packed_rows, 0, torch.uint8)]
        return _gather(mesh, parts, _local_reads(mesh, len(packed_rows)))

    return decode
