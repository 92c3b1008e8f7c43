"""Batched Huffman bitstream encode in plain PyTorch: the kernels' twins.

A port of ``dextractor_tpu/ops/bitstream_jax.py``.  The reference encodes
one symbol at a time through a 32-bit shift register (OCODE, QV.c:404-422);
here a rectangle of streams (N, L) is encoded at once:

  1. per-symbol emission values/widths from a packed 256-entry LUT
     (escapes fused: code || literal as one <= 32-bit emission);
  2. run lengths from a row-wise running maximum of literal positions;
  3. bit offsets from a row-wise cumulative sum of the widths;
  4. each emission's hi/lo word contributions scattered into an int64
     word buffer (the contributions are bit-disjoint, so add equals OR);
  5. the reference's tail padding (duplicate/zero word) applied on the host
     from per-row totals (``finalize_rows``).

``encode_plain_ref`` and ``encode_run_ref`` compute exactly what the CUDA
kernels K1 and K2 (ops/csrc/emit.cu) compute, with the same output shapes;
the wrappers in ops/emit.py take them for tensors on the CPU.  The emission
route of the encode step (parallel/pipeline.py) runs steps 1-3 here in
parts: ``run_setup`` (the runs), then every table lookup of the bucket in
one K9 launch (``ops.lut.lut_gather_groups``), then ``plain_emissions`` and
``run_assemble`` from the looked-up entries; it packs through K8
(``pack_words_any``).  The twins look up with ``lut_gather_plain``, so that
they launch no kernel.  All bit
arithmetic is int64, because ``torch.uint32`` has no shifts or adds on the
CPU; words are handed out as int32 tensors that hold u32 bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import dispatch
from .huffman import HScheme


def plain_width(l: int) -> int:
    """Words per row of a plain channel: <= 32 bits per symbol."""
    return l + 1


def run_width(l: int) -> int:
    """Words per row of an RLE channel: <= 64 bits per literal plus the
    trailing run."""
    return 2 * l + 2


def scheme_luts(scheme: HScheme, run: bool = False) -> np.ndarray:
    """Pack a scheme into a (256,) int32 LUT: ``bits << 6 | len << 1 | esc``.

    Symbol schemes escape only when type == 2 (Encode, QV.c:397-402); run
    schemes test code-equals-255's-code unconditionally (Encode_Run,
    QV.c:468-469), so their flag is set for every bucket sharing 255's code.
    Raises ValueError when an emission could exceed 32 bits, which the
    packing (and the reference's 32-bit emitter) cannot hold.
    """
    esc = np.zeros(256, np.int64)
    if run or scheme.type == 2:
        esc = ((scheme.codebits == scheme.codebits[255])
               & (scheme.codelens == scheme.codelens[255])).astype(np.int64)
    lens = scheme.codelens.astype(np.int64)
    if (lens + esc * (16 if run else 8)).max() > 32:
        raise ValueError("Huffman code too long for a 32-bit emission")
    packed = (scheme.codebits.astype(np.int64) << 6) | (lens << 1) | esc
    return packed.astype(np.int32)


def _to_words(w64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors of the same bit pattern."""
    return torch.where(w64 >= 1 << 31, w64 - (1 << 32), w64).to(torch.int32)


def lut_gather_plain(data, lut):
    """``lut[data]`` as int32: the 256-entry lookup that K9 computes
    (ops/lut.py), data uint8 or int32 in [0, 256)."""
    return lut.long()[data.long()].to(torch.int32)


def _unpack(packed):
    packed = packed.long()
    return packed >> 6, (packed >> 1) & 31, (packed & 1) == 1


def _sym_emissions(data, entries):
    """(value, width, granular width of the last part) per u8 symbol from
    its looked-up table entry."""
    bits, lens, esc = _unpack(entries)
    v = torch.where(esc, (bits << 8) | data.long(), bits)
    n = torch.where(esc, lens + 8, lens)
    gran = torch.where(esc, 8, lens)
    return v, n, gran


def _run_emission(run, entries):
    """Run code of min(run, 255) from its looked-up table entry; an escape
    appends run & 0xFFFF."""
    bits, lens, esc = _unpack(entries)
    v = torch.where(esc, (bits << 16) | (run & 0xFFFF), bits)
    n = torch.where(esc, lens + 16, lens)
    gran = torch.where(esc, 16, lens)
    return v, n, gran


def _row_setup(data, lengths):
    d = data.long()
    l = d.shape[1]
    col = torch.arange(l, device=d.device)[None, :]
    ln = lengths.long().clamp(0, l)
    return d, col, ln, col < ln[:, None]


def _at(x, idx):
    """x[i, idx[i]] per row (0 for an empty row axis)."""
    if x.shape[1] == 0:
        return torch.zeros_like(idx)
    return x.gather(1, idx[:, None])[:, 0]


def plain_emissions(data, lengths, entries):
    """Emissions of a non-RLE stream rectangle (N, L) u8: (v, n) of shape
    (N, L) and (t, last_gran) of shape (N,), all int64.  ``entries`` are
    the symbols' packed table entries, ``lut[data]`` (K9 on the card)."""
    _, _, ln, valid = _row_setup(data, lengths)
    v, n, gran = _sym_emissions(data, entries)
    v = torch.where(valid, v, 0)
    n = torch.where(valid, n, 0)
    t = n.sum(1)
    lg = torch.where(ln > 0, _at(gran, (ln - 1).clamp(min=0)), 0)
    return v, n, t, lg


class RunSetup(NamedTuple):
    """The run-length part of an RLE rectangle's emissions (``run_setup``)."""
    is_lit: torch.Tensor     # (N, L) bool: a valid position that is no rchar
    run: torch.Tensor        # (N, L) int64: the run before each position
    index: torch.Tensor      # (N, L) u8: min(run, 255), what the run table looks up
    last_lit: torch.Tensor   # (N,) int64: the row's last literal, -1 for none
    ln: torch.Tensor         # (N,) int64: the row's length, clamped to L


def run_setup(data, lengths, rchar):
    """The runs of an RLE stream rectangle (N, L) u8: its literals, and the
    run before each position from a running max of literal positions
    (bitstream_jax.py:126-130).  The runs are clamped to 255 for their
    table lookups, so ``index`` is u8."""
    d, col, ln, valid = _row_setup(data, lengths)
    n_rows, l = d.shape
    is_lit = valid & (d != rchar)
    lit_pos = torch.where(is_lit, col, -1)
    if l:
        run_max = torch.cummax(lit_pos, dim=1).values
        last_lit = run_max[:, -1]
    else:
        run_max = lit_pos
        last_lit = torch.full((n_rows,), -1, dtype=torch.long, device=d.device)
    prev_lit = torch.cat([torch.full_like(run_max[:, :1], -1), run_max[:, :-1]], 1)
    run = col - prev_lit - 1
    return RunSetup(is_lit, run, run.clamp(max=255).to(torch.uint8), last_lit, ln)


def run_assemble(data, setup, sym_entries, run_entries, run_luts):
    """Emissions of an RLE stream rectangle (N, L) u8 from its ``run_setup``
    and the looked-up entries of its symbols (``sym_lut[data]``) and runs
    (``run_lut[setup.index]``).

    Slots [2i, 2i+1] hold the run and the literal emission of position i
    (nonzero only where data[i] != rchar); slot 2L holds the trailing run.
    The trailing run's lookup, one per row, is a plain lookup in
    ``run_luts``, as in the JAX package."""
    is_lit, run, _, last_lit, ln = setup
    n_rows, l = data.shape
    rv, rn, _ = _run_emission(run, run_entries)
    rv = torch.where(is_lit, rv, 0)
    rn = torch.where(is_lit, rn, 0)
    sv, sn, sgran = _sym_emissions(data, sym_entries)
    sv = torch.where(is_lit, sv, 0)
    sn = torch.where(is_lit, sn, 0)

    trail = (ln - last_lit - 1).clamp(min=0)
    has_trail = trail > 0
    tv, tn, tgran = _run_emission(trail, lut_gather_plain(trail.clamp(max=255), run_luts))
    tv = torch.where(has_trail, tv, 0)
    tn = torch.where(has_trail, tn, 0)

    v = torch.cat([torch.stack([rv, sv], 2).reshape(n_rows, 2 * l), tv[:, None]], 1)
    n = torch.cat([torch.stack([rn, sn], 2).reshape(n_rows, 2 * l), tn[:, None]], 1)
    t = n.sum(1)
    lit_gran = _at(sgran, last_lit.clamp(min=0))
    lg = torch.where(has_trail, tgran, torch.where(last_lit >= 0, lit_gran, 0))
    return v, n, t, lg


def run_emissions(data, lengths, rchar, sym_luts, run_luts):
    """Emissions of an RLE stream rectangle (N, L) u8, its lookups plain:
    ``run_setup`` and ``run_assemble``."""
    setup = run_setup(data, lengths, rchar)
    return run_assemble(data, setup, lut_gather_plain(data, sym_luts),
                        lut_gather_plain(setup.index, run_luts), run_luts)


def pack_words(v, n, width: int):
    """Emissions (N, M) -> per-row words (N, width), width >= ceil(t/32).

    An emission lands in at most two words: a hi part in word off >> 5 and,
    when it crosses a word boundary, a lo part in the next one.  The parts
    are scattered with ``scatter_add_``; they never overlap in bits, so the
    sum is the OR.  Words past a row's ceil(t/32) are zero."""
    n_rows, m = v.shape
    off = torch.cumsum(n, 1) - n
    w = off >> 5
    pn = (off & 31) + n
    fits = pn <= 32
    hi = torch.where(fits, v << (32 - pn).clamp(0, 32), v >> (pn - 32).clamp(0, 32))
    hi = torch.where(n > 0, hi, 0)
    lo = torch.where(fits, 0, (v << (64 - pn).clamp(0, 63)) & 0xFFFFFFFF)
    words = torch.zeros((n_rows, width), dtype=torch.long, device=v.device)
    if m and width:
        words.scatter_add_(1, w.clamp(max=width - 1), hi)
        words.scatter_add_(1, (w + 1).clamp(max=width - 1), lo)
    return _to_words(words)


def pack_words_any(v, n):
    """Emission planes (N, M) int64 -> words (N, M+1) int32 through K8
    (ops/lut.pack_words): the kernel on CUDA, its twin on the CPU.  The
    values are narrowed to u32 bit patterns in int32 only here, since
    torch's ``>>`` on a negative int32 would sign-extend."""
    from .lut import pack_words as k8

    return k8(_to_words(v).contiguous(), n.to(torch.int32).contiguous())


def word_counts(t, last_gran):
    """(raw_words, out_words, dup, zero_ext) per row from totals.

    raw: ceil(T/32), what the word rows hold; out: what the reference
    encoder writes after its tail-padding rule."""
    olen = t & 31
    llen = (t - last_gran) & 31
    raw = (t + 31) >> 5
    dup = (olen > 0) & (llen > 16) & (olen > llen)
    zext = (olen == 0) & (llen > 16) & (t > 0)
    out = raw + dup.to(t.dtype) + zext.to(t.dtype)
    return raw, out, dup, zext


def _stack_rows(parts, c, n, width, device):
    if not c:
        z = torch.zeros((0, n), dtype=torch.int32, device=device)
        return torch.zeros((0, n, width), dtype=torch.int32, device=device), z, z
    words, ts, lgs = zip(*parts)
    return (torch.stack(words), torch.stack(ts).to(torch.int32),
            torch.stack(lgs).to(torch.int32))


def encode_plain_ref(data, lengths, sym_luts):
    """Plain twin of K1: data (C, N, L) u8, lengths (N,), sym_luts (C, 256)
    -> words (C, N, L+1) int32, t (C, N) int32, last_gran (C, N) int32."""
    dispatch.TWIN_CALLS["encode_plain"] += 1
    c, n, l = data.shape
    parts = []
    for k in range(c):
        v, nn, t, lg = plain_emissions(data[k], lengths,
                                       lut_gather_plain(data[k], sym_luts[k]))
        parts.append((pack_words(v, nn, plain_width(l)), t, lg))
    return _stack_rows(parts, c, n, plain_width(l), data.device)


def encode_run_ref(data, lengths, sym_luts, run_luts, rchars):
    """Plain twin of K2: as encode_plain_ref plus run_luts (C, 256) and
    rchars (C,) -> words (C, N, 2L+2), t, last_gran."""
    dispatch.TWIN_CALLS["encode_run"] += 1
    c, n, l = data.shape
    parts = []
    for k in range(c):
        v, nn, t, lg = run_emissions(data[k], lengths, rchars[k].long(),
                                     sym_luts[k], run_luts[k])
        parts.append((pack_words(v, nn, run_width(l)), t, lg))
    return _stack_rows(parts, c, n, run_width(l), data.device)


# ---------------------------------------------------------------------------
# host-side finishing: expand rows into the exact byte streams
# ---------------------------------------------------------------------------

def finalize_rows(words: np.ndarray, raw: np.ndarray, out: np.ndarray,
                  dup: np.ndarray, zext: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather each row's raw words into the padded output stream.

    Returns (flat u32 array of all rows concatenated, per-row word counts).
    A duplicated partial word repeats the final raw word; a zero-extension
    appends a zero word.  Only the first raw[i] words of row i are read.
    """
    n_rows = words.shape[0]
    out = out.astype(np.int64)
    raw = raw.astype(np.int64)
    total = int(out.sum())
    if total == 0:
        return np.empty(0, np.uint32), out
    starts = np.zeros(n_rows, np.int64)
    np.cumsum(out[:-1], out=starts[1:])
    rel = np.arange(total, dtype=np.int64) - np.repeat(starts, out)
    row = np.repeat(np.arange(n_rows, dtype=np.int64), out)
    src = np.minimum(rel, np.repeat(raw, out) - 1)
    is_extra = rel >= np.repeat(raw, out)
    use_zero = np.repeat(zext, out) & is_extra
    flat = words[row, src]
    flat[use_zero] = 0
    return flat, out
