"""Batched Huffman decode of .dexqv entries (``dextractor_tpu/ops/decode2.py``).

Each channel of each entry is an independent bit chain over its own
word-aligned rectangle row of little-endian u32 words (the native lens walk
gives every entry's channel boundaries, so the host slices them at memcpy
speed).  Per decoded symbol a chain peeks 16 bits at its bit position,
looks the top 8 up in an L1 table (``len << 9 | sym``, or ``1 << 20 | subid``
for a prefix whose code runs past 8 bits) and, for such a prefix, the next
``lmax - 8`` bits in an L2 subtable (``scheme_tables2``).  An escape symbol
reads an 8-bit literal after its code (a 16-bit run length in a run
chain).  Semantics: the reference's Decode/Decode_Run (QV.c:510-691) as the
JAX package's XLA chains formulate them.

This module holds the host tables, the plain PyTorch twins of the CUDA
kernels (``plain_chains``/``plain_chain`` for K4, ``run_chain`` for K5,
``expand_runs2``/``expand_del_tag`` for K6) and the five-channel step
``decode_entry_batch2``, which reaches the kernels through the wrappers in
``ops/decode_chains.py`` and ``ops/expand.py`` (a tensor on the CPU goes to
the twin, one on the card to the kernel).  Every twin returns what its
kernel returns, including the per-chain stats of the TPU kernels: ``bits``,
the final bit position (``pos0`` included), and ``last``, the width of the
last emission, 8 for an escape literal and 16 for a run escape.  The TPU
machinery of the JAX module (masked-reduce windows, one-hot lookups, the
shift-expansion network, the pair-step speculation) is not ported.

Bit arithmetic is int64 here (torch has no u32 shifts on the CPU); words
travel as int32 tensors holding u32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import dispatch

TAG_LETTERS = b"acgt"      # 2-bit delTag code -> letter (undexqv.c)


# ---------------------------------------------------------------------------
# host-side tables and rectangles
# ---------------------------------------------------------------------------

def scheme_tables2(schemes, lmax_bucket: int | None = None):
    """Two-level decode tables for a list of HSchemes.

    L1 (S, 256) i32 over the top 8 window bits: terminal entries pack
    ``len << 9 | sym``; prefixes whose code runs past 8 bits carry
    ``1 << 20 | subid``.  L2 is one flat (n_sub * subw,) i32 of
    ``len << 9 | sym`` rows, each ``subw = 2^(lmax-8)`` wide over window
    bits [8, lmax).  Returns (F1, F2flat, subw, lmax).
    """
    for s in schemes:
        s.with_lookup()
    return lookup_tables2([s.lookup for s in schemes], [s.codelens for s in schemes],
                          lmax_bucket)


def lookup_tables2(lookups, codelens, lmax_bucket: int | None = None):
    """``scheme_tables2`` from each scheme's 64K peek table (65536,), the
    symbol of every 16-bit window, and its code lengths (256,): the tables
    of the JAX package's v1 decoders (``lookups`` (S, 65536), ``lens_tbl``
    (S, 256)), whose codes are at most 16 bits long."""
    lmax = 1
    for lens in codelens:
        lmax = max(lmax, int(np.asarray(lens).max(initial=1)))
    if lmax_bucket is not None:
        lmax = max(lmax, lmax_bucket)
    lmax = 8 if lmax <= 8 else (12 if lmax <= 12 else 16)
    subw = 0 if lmax == 8 else 1 << (lmax - 8)

    f1 = np.zeros((len(lookups), 256), np.int32)
    f2_rows: list[np.ndarray] = []
    hi = np.arange(256) << 8
    for i, (look, lens) in enumerate(zip(lookups, codelens)):
        look = np.asarray(look)
        lens = np.asarray(lens).astype(np.int32)
        sym0 = look[hi]
        l0 = lens[sym0]
        term = l0 <= 8
        f1[i] = np.where(term, (l0 << 9) | sym0, 0)
        for h in np.flatnonzero(~term):
            row = look[(h << 8) + (np.arange(subw) << (16 - lmax))]
            f2_rows.append((lens[row] << 9) | row)
            f1[i, h] = (1 << 20) | len(f2_rows) - 1
    if f2_rows:
        f2 = np.concatenate(f2_rows).astype(np.int32)
    else:
        f2 = np.zeros(max(subw, 1), np.int32)
    return f1, f2, subw, lmax


def build_entry_rect(buf: np.ndarray, starts: np.ndarray, k_words: int):
    """Dense (N, K) little-endian u32 rectangle of per-entry bytes.

    Row r holds bytes buf[starts[r] : starts[r] + 4K] (clamped at the
    image end; the tail garbage is never consumed by a well-formed
    stream).  Host-side numpy, one fancy-index."""
    buf = np.asarray(buf, np.uint8)
    idx = np.asarray(starts, np.int64)[:, None] + np.arange(4 * k_words)
    b = buf[np.minimum(idx, max(len(buf) - 1, 0))]
    return np.ascontiguousarray(b).view(np.uint32)


def stream_word_counts(total_bits: np.ndarray, last_gran: np.ndarray) -> np.ndarray:
    """A stream's u32 word count from its chain's ``bits`` and ``last``: the
    encoder's tail-padding rule (the JAX package's
    ``ops/decode_jax.stream_word_counts``), so that the next stream of the
    entry starts 4 bytes a word further on."""
    t = np.asarray(total_bits).astype(np.int64)
    last = np.asarray(last_gran).astype(np.int64)
    olen = t & 31
    llen = (t - last) & 31
    raw = (t + 31) >> 5
    dup = (olen > 0) & (llen > 16) & (olen > llen)
    zext = (olen == 0) & (llen > 16) & (t > 0)
    return raw + dup.astype(np.int64) + zext.astype(np.int64)


# ---------------------------------------------------------------------------
# chain primitives (int64 tensors, one element per chain)
# ---------------------------------------------------------------------------

def _window(words, pos):
    """The first 63 bits of each chain's 64-bit window w[p >> 5] :
    w[(p >> 5) + 1] as a non-negative int64 (every read of a chain step
    ends by bit 63: a 16-bit peek at p <= 31, then at most a 16-bit code and
    a 16-bit escape literal); word reads past the row repeat its last word
    (decode2.py:228)."""
    k = words.shape[1]
    w = pos >> 5
    ab = words.gather(1, torch.stack([w, w + 1], 1).clamp(0, k - 1))
    return (ab[:, 0] << 31) | (ab[:, 1] >> 1)


def _bits_at(win, off, nbits: int):
    """Bits [off, off + nbits) of the window (decode2._peek16 / _extract);
    off + nbits <= 63."""
    return (win >> (63 - nbits - off)) & ((1 << nbits) - 1)


def _lookup(win, p, f1c, f2, subw: int, lmax: int):
    """``len << 9 | sym`` for the 16 window bits at p via the two-level
    tables; an L2 index past the table reads 0 (decode2._oh_lookup)."""
    cw = _bits_at(win, p, 16)
    e = f1c[cw >> 8]
    if subw:
        is2 = ((e >> 20) & 1) == 1
        idx2 = (e & 0xFFFF) * subw + ((cw >> (16 - lmax)) & (subw - 1))
        ok = is2 & (idx2 < f2.shape[0])
        e2 = torch.where(ok, f2[idx2.clamp(max=f2.shape[0] - 1)], 0)
        e = torch.where(is2, e2, e)
    return e


def _chain_inputs(rect, rlens, pos0):
    n = rlens.shape[0]
    words = rect.long() & 0xFFFFFFFF
    if words.shape[1] == 0:
        words = torch.zeros((n, 1), dtype=torch.long, device=rect.device)
    pos = (torch.zeros(n, dtype=torch.long, device=rect.device) if pos0 is None
           else pos0.long().clone())
    return words, rlens.long(), pos


def _stats(pos, last):
    return pos.to(torch.int32), last.to(torch.int32)


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def plain_chain(rect, rlens, f1c, f2, signal: int, *, max_len: int,
                subw: int, lmax: int, pos0=None):
    """Decode N plain streams, one per rectangle row (Decode, QV.c:510-599).

    rect (N, K) i32 words, rlens (N,), f1c (256,) L1, f2 flat L2, signal
    255 for a type-2 scheme (its escape) and 256 otherwise (never matches);
    pos0 (N,) optional starting bit offsets.  Each chain decodes
    min(rlen, max_len) symbols.  Returns (syms (N, max_len) u8, zero past
    the chain, bits (N,) i32, last (N,) i32)."""
    words, rl, pos = _chain_inputs(rect, rlens, pos0)
    rl = rl.clamp(0, max_len)
    f1c, f2 = f1c.long(), f2.long()
    n = rl.shape[0]
    last = torch.zeros_like(pos)
    out = torch.zeros((n, max_len), dtype=torch.uint8, device=rect.device)
    for j in range(int(rl.max()) if n else 0):
        active = j < rl
        win = _window(words, pos)
        p = pos & 31
        e = _lookup(win, p, f1c, f2, subw, lmax)
        sym = e & 511
        nb = (e >> 9) & 31
        esc = sym == signal
        sym = torch.where(esc, _bits_at(win, p + nb, 8), sym)
        pos = torch.where(active, pos + torch.where(esc, nb + 8, nb), pos)
        last = torch.where(active, torch.where(esc, 8, nb), last)
        out[:, j] = torch.where(active, sym, 0).to(torch.uint8)
    return (out, *_stats(pos, last))


def plain_chains(rects, rlens, f1, f2, signals, subws, *, max_len: int,
                 lmax: int, pos0=None):
    """Twin of K4: C plain channels over the same entries.  rects is a list
    of C (N, K_c) rectangles, f1 (C, 256), signals/subws C ints, pos0
    optional (C, N).  Returns (syms (C, N, max_len) u8, bits (C, N) i32,
    last (C, N) i32)."""
    dispatch.TWIN_CALLS["decode_plain"] += 1
    n = rlens.shape[0]
    parts = [plain_chain(r, rlens, f1[c], f2, int(signals[c]), max_len=max_len,
                         subw=int(subws[c]), lmax=lmax,
                         pos0=None if pos0 is None else pos0[c])
             for c, r in enumerate(rects)]
    if not parts:
        z = torch.zeros((0, n), dtype=torch.int32, device=rlens.device)
        return (torch.zeros((0, n, max_len), dtype=torch.uint8,
                            device=rlens.device), z, z)
    return tuple(torch.stack(x) for x in zip(*parts))


def run_chain(rect, rlens, f1r, f1s, f2, nsignal: int, *, max_tokens: int,
              subw: int, lmax: int, pos0=None, carry=None):
    """Twin of K5: decode N RLE streams into (runlen, literal) tokens
    (Decode_Run, QV.c:604-691).

    Per token: a run code (its escape, symbol 255, is followed by a 16-bit
    run length); ``emitted1 = min(emitted + run, rlen)``; a literal code
    only when ``emitted1 < rlen`` (its escape is ``nsignal``, followed by
    8 bits).  A chain stops at ``emitted == rlen`` or after ``max_tokens``
    tokens.  With ``carry[i] >= 0`` chain i resumes from a checkpoint inside
    a run: token 0 is the pair (carry, literal at pos0), no run code is
    read.  Padding tokens are run 0, literal -1.  Returns (runs (N, T) i32,
    lits (N, T) i32, bits (N,) i32, last (N,) i32), T = max_tokens."""
    dispatch.TWIN_CALLS["decode_run"] += 1
    words, rl, pos = _chain_inputs(rect, rlens, pos0)
    f1r, f1s, f2 = f1r.long(), f1s.long(), f2.long()
    n = rl.shape[0]
    dev = rect.device
    emitted = torch.zeros_like(pos)
    last = torch.zeros_like(pos)
    runs = torch.zeros((n, max_tokens), dtype=torch.int32, device=dev)
    lits = torch.full((n, max_tokens), -1, dtype=torch.int32, device=dev)
    for t in range(max_tokens):
        active = emitted < rl
        if not bool(active.any()):
            break
        win = _window(words, pos)
        p = pos & 31
        e = _lookup(win, p, f1r, f2, subw, lmax)
        c = e & 511
        nb = (e >> 9) & 31
        resc = c == 255
        runlen = torch.where(resc, _bits_at(win, p + nb, 16), c)
        adv = nb + torch.where(resc, 16, 0)
        if t == 0 and carry is not None:
            phase = carry.long() >= 0
            runlen = torch.where(phase, carry.long(), runlen)
            resc = resc & ~phase
            adv = torch.where(phase, 0, adv)
        pos = torch.where(active, pos + adv, pos)
        last = torch.where(active, torch.where(resc, 16, nb), last)
        emitted1 = torch.minimum(emitted + runlen, rl)

        need = active & (emitted1 < rl)
        win = _window(words, pos)
        p = pos & 31
        e2 = _lookup(win, p, f1s, f2, subw, lmax)
        sym = e2 & 511
        snb = (e2 >> 9) & 31
        sesc = sym == nsignal
        sym = torch.where(sesc, _bits_at(win, p + snb, 8), sym)
        pos = torch.where(need, pos + torch.where(sesc, snb + 8, snb), pos)
        last = torch.where(need, torch.where(sesc, 8, snb), last)

        runs[:, t] = torch.where(active, runlen, 0).to(torch.int32)
        lits[:, t] = torch.where(need, sym, -1).to(torch.int32)
        emitted = torch.where(active, emitted1 + need.long(), emitted)
    return (runs, lits, *_stats(pos, last))


def _literal_columns(runs, lits, max_len: int):
    """Row and column of every literal that lands in [0, max_len): literal
    k goes to column cumsum(runs)[k] + k."""
    n, t = runs.shape
    col = torch.cumsum(runs.long(), 1) + torch.arange(t, device=runs.device)
    keep = (lits >= 0) & (col < max_len)
    row = torch.arange(n, device=runs.device)[:, None].expand(n, t)
    return row[keep], col[keep], keep


def expand_runs2(runs, lits, rchar: int, *, max_len: int):
    """Twin of K6: (runlen, literal) tokens -> symbol rows (N, max_len) u8,
    ``rchar`` wherever no literal lands."""
    dispatch.TWIN_CALLS["expand_runs"] += 1
    rows = torch.full((runs.shape[0], max_len), rchar & 0xFF, dtype=torch.uint8,
                      device=runs.device)
    r, c, keep = _literal_columns(runs, lits, max_len)
    rows[r, c] = lits[keep].to(torch.uint8)
    return rows


def expand_del_tag(runs, lits, codes_t, rchar: int, *, max_len: int):
    """Twin of K6 with tag codes: expand delQV tokens, and place the delTag
    letter of literal k beside it.  Literal k is the k-th kept (non-delChar)
    symbol of the read, so its packed tag code is code k (QV.c:824-847).
    codes_t (N, T) 2-bit codes.  Returns (del_rows (N, max_len) u8,
    tag_rows (N, max_len) i8: the letter under every literal, -1 at the
    holes, which the caller turns into 'n' inside the read)."""
    dispatch.TWIN_CALLS["expand_runs"] += 1
    n = runs.shape[0]
    rows = torch.full((n, max_len), rchar & 0xFF, dtype=torch.uint8, device=runs.device)
    tags = torch.full((n, max_len), -1, dtype=torch.int8, device=runs.device)
    r, c, keep = _literal_columns(runs, lits, max_len)
    rows[r, c] = lits[keep].to(torch.uint8)
    tags[r, c] = _tag_letters(codes_t[keep]).to(torch.int8)
    return rows, tags


def _unpack_tag_codes(tag_bytes, width: int):
    """Positional 2-bit delTag unpack: code k of each row lands at column
    k (Unpack_Tag order, first code in bits 7-6, QV.c:824-847, DB.c:334).
    (N, TB) u8 -> (N, width) i32, 0 past the row's 4*TB codes."""
    n, tb = tag_bytes.shape
    shifts = torch.tensor([6, 4, 2, 0], device=tag_bytes.device)
    codes = ((tag_bytes.long()[:, :, None] >> shifts) & 3).reshape(n, 4 * tb)
    if codes.shape[1] < width:
        codes = torch.nn.functional.pad(codes, (0, width - codes.shape[1]))
    return codes[:, :width].to(torch.int32)


def _tag_letters(codes):
    """2-bit code -> ascii 'a/c/g/t'."""
    lut = torch.tensor(list(TAG_LETTERS), dtype=torch.int32, device=codes.device)
    return lut[codes.long()]


# ---------------------------------------------------------------------------
# fused five-channel entry decode
# ---------------------------------------------------------------------------

_POS0_ROW = {0: 0, 2: 1, 3: 2, 4: 3}   # channel (del, ins, mrg, sub) -> pos0 row


def decode_entry_batch2(rect_del, tag_bytes, rect_ins, rect_mrg, rect_sub,
                        rlens, sids, f1, f2, types, del_char, sub_char, *,
                        max_len: int, max_tokens: int, del_mode: str,
                        sub_mode: str, subw: int, lmax: int,
                        chan_l2: tuple | None = None, pos0=None, carry=None):
    """Five-channel .dexqv entry decode of N entries on rlens' device.

    rect_del/ins/mrg/sub: (N, K_c) i32 channel words (u32 bit patterns);
    tag_bytes (N, TB) u8 packed delTag bytes from the channel's start
    (bytes past a row's codes are garbage and never read); rlens (N,) i32;
    sids (6,) scheme ids of (del, drun, ins, mrg, sub, srun) and types (S,)
    scheme types, both read on the host; f1 (S, 256) i32 L1 tables; f2 flat
    i32 L2; del_char/sub_char the run characters (ints).  ``chan_l2[k]``
    False lets channel k skip the L2 table (its scheme is all L1-terminal).
    pos0 (4, N) i32 and carry (2, N) i32, both optional, start every chain
    of del, ins, mrg, sub at a bit offset and the run chains of del and sub
    inside a run (``decode_entry_batch_seg``).

    The plain channels (ins, mrg, and del/sub when not run-coded) decode in
    one K4 launch, each run channel through K5, and run expansion through
    K6, which also places the delTag letters in run-del mode.  Tag unpack,
    the in-read masks and the final stack are plain torch.  Semantics of
    the sequential decoder (QV.c:1428-1477).  Returns (5, N, max_len) u8
    rows: del, tag, ins, mrg, sub, zero past each read."""
    from . import decode_chains, expand

    sids = _host(sids).tolist()
    sig, sw = channel_params(sids, types, subw, chan_l2)
    dev = rlens.device
    in_read = torch.arange(max_len, device=dev)[None, :] < rlens[:, None]

    plain = [(2, rect_ins), (3, rect_mrg)]
    if del_mode != "run":
        plain.append((0, rect_del))
    if sub_mode != "run":
        plain.append((4, rect_sub))
    ks = [k for k, _ in plain]
    f1p = torch.stack([f1[sids[k]] for k in ks])
    p0 = None if pos0 is None else torch.stack([pos0[_POS0_ROW[k]] for k in ks])
    psyms, _, _ = decode_chains.decode_plain(
        [r for _, r in plain], rlens, f1p, f2, [sig[k] for k in ks],
        [sw[k] for k in ks], max_len=max_len, lmax=lmax, pos0=p0)
    prow = dict(zip(ks, psyms))

    def run_rows(rect, k_sym, k_run, rchar, tags, j):
        runs, lits, _, _ = decode_chains.decode_run(
            rect, rlens, f1[sids[k_run]], f1[sids[k_sym]],
            f2, sig[k_sym], max_tokens=max_tokens, subw=max(sw[k_sym], sw[k_run]),
            lmax=lmax, pos0=None if pos0 is None else pos0[_POS0_ROW[k_sym]],
            carry=None if carry is None else carry[j])
        return expand.expand_runs(runs, lits, int(rchar), max_len=max_len,
                                  tag_bytes=tags)

    if del_mode == "run":
        del_rows, tag_r = run_rows(rect_del, 0, 1, del_char, tag_bytes, 0)
        tag_rows = torch.where(tag_r >= 0, tag_r.to(torch.uint8),
                               in_read.to(torch.uint8) * ord("n"))
    else:
        del_rows = prow[0]
        tag_rows = _tag_letters(_unpack_tag_codes(tag_bytes, max_len)).to(torch.uint8)
    if sub_mode == "run":
        sub_rows, _ = run_rows(rect_sub, 4, 5, sub_char, None, 1)
    else:
        sub_rows = prow[4]
    return torch.stack([torch.where(in_read, r, 0) for r in
                        (del_rows, tag_rows, prow[2], prow[3], sub_rows)])


def decode_entry_batch_seg(rect_del, tag_in, rect_ins, rect_mrg, rect_sub,
                           seg_rlens, pos0, carr, sids, f1, f2, types, del_char,
                           sub_char, *, seg: int, max_tokens: int, del_mode: str,
                           sub_mode: str, subw: int, lmax: int,
                           chan_l2: tuple | None = None):
    """Segmented five-channel decode: NS segment rows, each an independent
    chain of at most ``seg`` symbols resumed at a checkpoint of the native
    lens walk (the JAX package's ``decode_entry_batch_seg`` in its flat
    layout, one row per live segment; its bucketed layout of several
    segments per row is not ported).  K4 decodes the plain channels from
    each row's ``pos0``, K5 the RLE channels from ``pos0`` and the run
    ``carr``, and K6 expands their tokens, with the delTag codes.

    rect_* (NS, K_c) i32 segment rectangles; tag_in (NS, TB) u8 packed
    delTag codes of each segment (``qv_batch.build_seg_launch_flat``);
    seg_rlens (NS,) i32; pos0 (4, NS) i32; carr (2, NS) i32; the rest as
    ``decode_entry_batch2``'s.  Returns (5, NS, seg) u8 segment rows."""
    return decode_entry_batch2(
        rect_del, tag_in, rect_ins, rect_mrg, rect_sub, seg_rlens, sids, f1, f2,
        types, del_char, sub_char, max_len=seg, max_tokens=max_tokens,
        del_mode=del_mode, sub_mode=sub_mode, subw=subw, lmax=lmax,
        chan_l2=chan_l2, pos0=pos0, carry=carr)


def channel_params(sids, types, subw: int, chan_l2=None):
    """Per channel k of (del, drun, ins, mrg, sub, srun): its escape signal
    (255 for a type-2 scheme, else 256, which never matches) and its L2 row
    width (0 when ``chan_l2[k]`` says its scheme is all L1-terminal)."""
    sids = _host(sids).tolist()
    types = _host(types).tolist()
    sig = [255 if int(types[sids[k]]) == 2 else 256 for k in range(6)]
    sw = [subw if (chan_l2 is None or chan_l2[k]) else 0 for k in range(6)]
    return sig, sw


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
