"""Batched Huffman decode of independent streams on K4b and K5
(``dextractor_tpu/ops/decode_jax.py``).

``decode_plain_batch`` and ``decode_run_batch`` take the JAX package's v1
arguments: a container image, each stream's byte offset, its symbol count
and its scheme ids, and the schemes' 64K peek tables (``lookups``), code
lengths (``lens_tbl``) and types.  They return what the JAX functions
return, in the same order: per stream the symbols (or the (run, literal)
tokens), the stream's total bits and the width of its last emission,
which ``decode2.stream_word_counts`` turns into its u32 word count.

Both run on ``decode_streams``, the one launch path of K4b and K5 for a
batch of streams, which the per-scheme route of a Dazzler DB's QV load
(``codecs/qv_batch.batch_decode_entries``) shares: the streams are grouped
by scheme (plain) or by (symbol, run) scheme pair (RLE) and by the pow2
width of their rectangle, each group's rectangle is sliced from the image
(``decode2.build_entry_rect``), its chains are split over the shards of a
mesh, and K4b (``decode_chains.decode_plain`` with C = 1) or K5
(``decode_chains.decode_run``) decodes each shard's block in one launch.
On the CPU the wrappers run their twins (``decode2.plain_chains``,
``decode2.run_chain``).

The v1 signature has no stream ends, so a stream's bytes are bounded by
its symbol count: a plain symbol takes at most 24 bits (a 16-bit code and
an 8-bit escape literal), an RLE token at most 56 (a 16-bit run code, its
16-bit escape length, a 16-bit literal code and its 8-bit escape), and a
token carries at least one symbol.  The bound is clamped at the image end,
where ``build_entry_rect`` repeats the last byte, as the JAX package's
``_word_peek16`` clamps its reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import stage
from . import decode2 as d2

PLAIN_SYMBOL_BITS = 24     # a 16-bit code + an 8-bit escape literal
RUN_TOKEN_BITS = 56        # 16-bit run code + 16-bit length + 16-bit code + 8-bit literal


@dataclass(frozen=True)
class StreamTables:
    """The two-level tables of S schemes on each shard's device: f1
    {device: (S, 256) i32}, f2 {device: flat i32}; per scheme its escape
    signal (255 for a type-2 scheme, else 256) and its L2 row width (0 when
    all its L1 entries are terminal); lmax the L2 window's end."""

    f1: dict
    f2: dict
    sig: list
    sw: list
    lmax: int


def stream_tables(lookups, codelens, types, devices) -> StreamTables:
    """``StreamTables`` from each scheme's 64K peek table, code lengths and
    type (``decode2.lookup_tables2``), copied to every device of
    ``devices``."""
    f1, f2, subw, lmax = d2.lookup_tables2(lookups, codelens)
    return StreamTables(
        f1={d: torch.from_numpy(f1).to(d) for d in devices},
        f2={d: torch.from_numpy(f2).to(d) for d in devices},
        sig=[255 if int(t) == 2 else 256 for t in np.asarray(types).reshape(-1)],
        sw=[subw if ((f1[k] >> 20) & 1).any() else 0 for k in range(len(f1))],
        lmax=lmax)


def rect_width(spans) -> np.ndarray:
    """Per-stream pow2 rectangle width in u32 words for byte spans ``spans``
    (16 words of slack; at least 64), the JAX package's ``_kw_buckets``."""
    return np.maximum(64, 2 ** np.ceil(np.log2(np.maximum(
        np.asarray(spans, np.int64) // 4 + 16, 1))).astype(np.int64))


def decode_streams(mesh, buf, starts, spans, rlens, sym_ids, run_ids, tables, width):
    """Decode N Huffman streams, one chain each, through K4b or K5.

    buf (B,) u8 image; starts (N,) i64 each stream's byte offset; spans
    (N,) i64 a bound of its bytes, which sets its rectangle's width; rlens
    (N,) i32 its symbols; sym_ids (N,) its scheme and run_ids (N,) its run
    scheme, -1 for a plain stream; ``tables`` the schemes'
    ``StreamTables`` on the mesh's devices; width(sel) the launch width of
    the group of streams ``sel``: symbols per row of K4b, tokens per row of
    K5.  The streams are grouped by (scheme, run scheme) and rectangle
    width, one launch a group and shard (the chains split over the shards
    of ``mesh``).  Yields, for each group, (sel, its width, its outputs on
    ``mesh.device`` in the order of sel): (symbols (n, w) u8, bits (n,)
    i32, last (n,) i32) of a plain group, (runs (n, w) i32, lits (n, w)
    i32, bits, last) of an RLE one."""
    from ..parallel.multihost import mesh_put
    from . import decode_chains

    put = mesh_put(mesh)
    sym_ids = np.asarray(sym_ids, np.int64)
    run_ids = np.asarray(run_ids, np.int64)
    kws = rect_width(spans)
    keys = sym_ids * (len(tables.sig) + 1) + run_ids + 1

    def kern(rect, rl, s, r, w):
        dev = rl.device
        f1, f2 = tables.f1[dev], tables.f2[dev]
        if r < 0:
            syms, bits, last = decode_chains.decode_plain(
                [rect], rl, f1[s:s + 1], f2, [tables.sig[s]], [tables.sw[s]], max_len=w,
                lmax=tables.lmax)
            return syms[0], bits[0], last[0]
        return decode_chains.decode_run(
            rect, rl, f1[r], f1[s], f2, tables.sig[s], max_tokens=w,
            subw=max(tables.sw[s], tables.sw[r]), lmax=tables.lmax)

    for key in np.unique(keys):
        for kw in np.unique(kws[keys == key]):
            sel = np.flatnonzero((keys == key) & (kws == kw))
            s, r, w = int(sym_ids[sel[0]]), int(run_ids[sel[0]]), int(width(sel))
            with stage("rects"):
                rect = d2.build_entry_rect(buf, starts[sel], int(kw))
            with stage("step"):
                parts = [kern(x, rl, s, r, w) for x, rl in zip(put(rect), put(rlens[sel]))]
                yield sel, w, [torch.cat([p[i].to(mesh.device) for p in parts])[:len(sel)]
                               for i in range(len(parts[0]))]


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    elif isinstance(x, (bytes, bytearray, memoryview)):
        x = np.frombuffer(x, np.uint8)
    return np.asarray(x).astype(dtype, copy=False)


def _batch(buf, starts, rlens, lookups, lens_tbl, types, device, stream_bits):
    """Host arrays, the device, a one-shard mesh on it, the tables there and
    each stream's byte bound from ``stream_bits`` (N,), clamped at the
    image end."""
    from ..parallel.mesh import local_device, make_mesh

    dev = local_device(device)
    buf = _host(buf, np.uint8)
    starts = _host(starts, np.int64)
    rlens = _host(rlens, np.int32)
    tables = stream_tables(_host(lookups, np.int32), _host(lens_tbl, np.int32),
                           _host(types, np.int32), [dev])
    spans = np.clip(np.minimum((stream_bits + 7) // 8, len(buf) - starts), 0, None)
    return buf, starts, rlens, dev, make_mesh(1, dev), tables, spans


def decode_plain_batch(buf, starts, rlens, scheme_ids, lookups, lens_tbl, types, *,
                       max_len: int, device=None):
    """Decode N plain streams, one K4b chain each (Decode, QV.c:510-599).

    buf (B,) u8 the image (numpy, a tensor or bytes); starts (N,) byte
    offset of each stream; rlens (N,) symbols to decode; scheme_ids (N,)
    index into the tables; lookups (S, 65536) i32, lens_tbl (S, 256) i32,
    types (S,) i32.  Each stream decodes min(rlen, max_len) symbols.  Runs
    on ``device`` (None: the current card; raises without CUDA).  Returns
    (symbols (N, max_len) u8, zero past each stream, total_bits (N,) i32,
    last_gran (N,) i32), tensors on the device."""
    buf, starts, rlens, dev, mesh, tables, spans = _batch(
        buf, starts, rlens, lookups, lens_tbl, types, device,
        PLAIN_SYMBOL_BITS * np.clip(_host(rlens, np.int64), 0, max_len))
    n = len(starts)
    syms = torch.zeros((n, max_len), dtype=torch.uint8, device=dev)
    bits = torch.zeros(n, dtype=torch.int32, device=dev)
    last = torch.zeros(n, dtype=torch.int32, device=dev)
    for sel, _, got in decode_streams(mesh, buf, starts, spans, rlens,
                                      _host(scheme_ids, np.int64), np.full(n, -1),
                                      tables, lambda sel: max_len):
        idx = torch.from_numpy(sel).to(dev)
        for out, g in zip((syms, bits, last), got):
            out[idx] = g
    return syms, bits, last


def decode_run_batch(buf, starts, rlens, sym_ids, run_ids, lookups, lens_tbl, types, *,
                     max_tokens: int, device=None):
    """Decode N RLE streams into (run, literal) tokens, one K5 chain each
    (Decode_Run, QV.c:604-691).

    Arguments as ``decode_plain_batch``'s, with sym_ids (N,) the literal
    scheme and run_ids (N,) the run scheme of each stream.  Each token is a
    run code (an escape, symbol 255, is followed by a 16-bit length) and,
    while symbols remain, a literal code; a stream stops after its rlen
    symbols or ``max_tokens`` tokens.  Returns (runs (N, max_tokens) i32,
    lits (N, max_tokens) i32 with -1 for none, n_tokens (N,) i32,
    total_bits (N,) i32, last_gran (N,) i32): ``n_tokens`` is, as the JAX
    function's, the symbols the tokens carry, capped at rlen."""
    buf, starts, rlens, dev, mesh, tables, spans = _batch(
        buf, starts, rlens, lookups, lens_tbl, types, device,
        RUN_TOKEN_BITS * np.minimum(np.clip(_host(rlens, np.int64), 0, None), max_tokens))
    n = len(starts)
    runs = torch.zeros((n, max_tokens), dtype=torch.int32, device=dev)
    lits = torch.full((n, max_tokens), -1, dtype=torch.int32, device=dev)
    bits = torch.zeros(n, dtype=torch.int32, device=dev)
    last = torch.zeros(n, dtype=torch.int32, device=dev)
    for sel, _, got in decode_streams(mesh, buf, starts, spans, rlens,
                                      _host(sym_ids, np.int64), _host(run_ids, np.int64),
                                      tables, lambda sel: max_tokens):
        idx = torch.from_numpy(sel).to(dev)
        for out, g in zip((runs, lits, bits, last), got):
            out[idx] = g
    carried = runs.long().sum(1) + (lits >= 0).sum(1)
    cap = torch.from_numpy(np.clip(rlens, 0, None)).to(dev)
    return runs, lits, torch.minimum(carried, cap).to(torch.int32), bits, last


def expand_runs_np(runs: np.ndarray, lits: np.ndarray, rlens: np.ndarray,
                   rchar: int) -> np.ndarray:
    """Expand (runlen, literal) token pairs into symbol rows (host side):
    (N, max(rlens)) u8, ``rchar`` wherever no literal lands."""
    n, t = runs.shape
    max_len = int(rlens.max(initial=0))
    out = np.full((n, max_len), rchar, np.uint8)
    # literal positions: runlen cumsum + token index
    starts = np.cumsum(runs, axis=1) + np.arange(t)[None, :]
    valid = lits >= 0
    rows = np.repeat(np.arange(n), t).reshape(n, t)
    out[rows[valid], starts[valid]] = lits[valid].astype(np.uint8)
    return out
