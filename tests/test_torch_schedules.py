"""NumPy models of the work schedules of two CUDA kernels, which cannot run
on this host: K8 ``pack_words`` as tiles of a row across blocks with a
decoupled look-back (ops/csrc/emit.cu), and K5 ``decode_run`` as one warp
per chain whose lanes speculate, synchronise, scan and write
(ops/csrc/decode.cu).  Each model follows its kernel step by step at small
tile and lane sizes and is held against the kernel's plain twin."""

import functools

import numpy as np
import pytest
import torch

from dextractor_tpu_torch.ops import bitstream_torch as bt
from dextractor_tpu_torch.ops import decode2 as d2
from dextractor_tpu_torch.testing import decode_edge_cases

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# K8: tiles of a row, decoupled look-back, edge words
# ---------------------------------------------------------------------------

def _combine(a, b):
    """The look-back operator on (bit count, last <= 32 bits right-aligned):
    the stream a followed by the stream b."""
    if b[0] >= 32:
        return a[0] + b[0], b[1]
    if b[0] == 0:
        return a
    return a[0] + b[0], ((a[1] << b[0]) | b[1]) & M32


def _last32(loc, a):
    """The last min(a, 32) bits of a tile's local words, right-aligned."""
    if a == 0:
        return 0
    w1, r = (a - 1) >> 5, a & 31
    if r == 0:
        return loc[w1]
    val = loc[w1] >> (32 - r)
    if w1:
        val |= (loc[w1 - 1] << r) & M32
    return val


def pack_words_tiles(v, n, tile, rng):
    """The K8 kernel's schedule: tiles of ``tile`` slots taken in ticket
    (row-major) order; each places its emissions in local words from bit 0,
    publishes its aggregate, looks back over its row's earlier tiles (each
    seen with its inclusive prefix or, at random, only its aggregate) and
    writes the words whose last bit it holds; the row's last tile writes the
    partial last word and the zeros.  Every word must be written once."""
    rows, m = v.shape
    tpr = max(1, -(-m // tile))
    out = np.zeros((rows, m + 1), np.int64)
    writes = np.zeros((rows, m + 1), np.int64)
    agg, inc = {}, {}
    for ticket in range(rows * tpr):
        row, k = divmod(ticket, tpr)
        lo, hi = k * tile, min((k + 1) * tile, m)
        loc = [0] * (tile + 1)
        bit = 0
        for j in range(lo, hi):
            val, w = int(v[row, j]), int(n[row, j])
            if w:
                end = bit + w                          # MSB-first at bit
                for q in range(bit >> 5, ((end - 1) >> 5) + 1):
                    shift = 32 * (q + 1) - end
                    loc[q] |= ((val << shift) if shift >= 0 else (val >> -shift)) & M32
            bit += w
        a = (bit, _last32(loc, bit))
        agg[ticket] = a
        excl = (0, 0)
        for j in range(k - 1, -1, -1):             # look back in the row
            t = row * tpr + j
            if t in inc and rng.random() < 0.5:
                excl = _combine(inc[t], excl)
                break
            excl = _combine(agg[t], excl)
        inc[ticket] = _combine(excl, a)
        s, o, e = excl[0], excl[0] & 31, excl[0] + bit
        last_tile = k == tpr - 1
        n_words = (e >> 5) - (s >> 5) + (1 if last_tile and e & 31 else 0)
        for i in range(n_words):
            prev = excl[1] if i == 0 else loc[i - 1]
            word = loc[i] if o == 0 else ((prev << (32 - o)) | (loc[i] >> o)) & M32
            out[row, (s >> 5) + i] = word
            writes[row, (s >> 5) + i] += 1
        if last_tile:
            writes[row, (e + 31) >> 5:] += 1
    assert (writes == 1).all(), "a word written other than once"
    return out


def _k8_rows(kind, rng):
    """Emission planes (v, n) with zero-width runs over several tiles,
    32-bit emissions and rows of every bit count mod 32."""
    rows, m = 6, 197
    n = rng.integers(0, 33, (rows, m))
    if kind == "zero_runs":
        n[:, 20:150] = 0
        n[1] = 0
        n[2, 1:] = 0
        n[3, ::7] = 32
    elif kind == "wide":
        n[:] = 32
        n[1, 0] = 3
        n[4, -1] = 5
    elif kind == "sparse":
        n = np.where(rng.random((rows, m)) < 0.1, n, 0)
    v = rng.integers(0, 1 << 32, (rows, m), dtype=np.uint64) & ((1 << n) - 1).astype(np.uint64)
    return v.astype(np.int64), n


@pytest.mark.parametrize("tile", [4, 7, 16, 64])
@pytest.mark.parametrize("kind", ["zero_runs", "wide", "sparse"])
def test_pack_words_tile_schedule(kind, tile):
    rng = np.random.default_rng(hash((kind, tile)) % 2**32)
    v, n = _k8_rows(kind, rng)
    ref = bt.pack_words(torch.from_numpy(v), torch.from_numpy(n), v.shape[1] + 1)
    got = pack_words_tiles(v, n, tile, rng)
    np.testing.assert_array_equal(got, ref.numpy().astype(np.int64) & M32)


# ---------------------------------------------------------------------------
# K5: one warp per chain
# ---------------------------------------------------------------------------

class _Chain:
    """One run chain's words and tables, read as the kernel reads them."""

    def __init__(self, words, f1r, f1s, f2, subw, lmax, nsignal):
        self.words = [int(x) & M32 for x in words]
        self.f1 = (list(map(int, f1r)), list(map(int, f1s)))
        self.f2 = list(map(int, f2))
        self.subw, self.lmax, self.nsignal = subw, lmax, nsignal

    def _word(self, i):                 # reads past the row repeat its last word
        return self.words[max(0, min(i, len(self.words) - 1))]

    def _lookup(self, l1, cw):
        e = l1[cw >> 8]
        if self.subw and (e >> 20) & 1:
            i2 = (e & 0xFFFF) * self.subw + ((cw >> (16 - self.lmax)) & (self.subw - 1))
            e = self.f2[i2] if i2 < len(self.f2) else 0
        return e

    def step(self, pos, phase):
        """One code at (pos, phase): (value, new pos, width of its last
        emission); phase 0 reads a run code, 1 a literal code."""
        w = (self._word(pos >> 5) << 32) | self._word((pos >> 5) + 1)
        p = pos & 31

        def bits(off, nb):
            return (w >> (64 - nb - off)) & ((1 << nb) - 1)

        e = self._lookup(self.f1[phase], bits(p, 16))
        nb, sym = (e >> 9) & 31, e & 511
        if phase == 0:
            if sym == 255:                          # run escape: 16 bits follow
                return bits(p + nb, 16), pos + nb + 16, 16
            return sym, pos + nb, nb
        if sym == self.nsignal:                     # literal escape: 8 bits follow
            return bits(p + nb, 8), pos + nb + 8, 8
        return sym, pos + nb, nb


def decode_run_warp(ch, rlen, max_tokens, pos0, carry, lane_bits):
    """The K5 kernel's schedule for one chain: windows of 32 lanes of
    ``lane_bits`` bits; lanes guess a start in the run phase, re-decode from
    their left neighbour's exit until no start changes, scan their token and
    symbol counts, and decode again to write.  Returns (runs, lits, bits,
    last) with padding tokens (0, -1)."""
    lanes, cap = 32, 2 * lane_bits + 2
    runs, lits = [0] * max_tokens, [-1] * max_tokens
    if rlen <= 0 or max_tokens <= 0:
        return runs, lits, pos0, 0
    pos, phase, tok, em = pos0, 0, 0, 0
    if carry >= 0:                  # token 0 is (carry, literal at pos0)
        runs[0], tok, em, phase = carry, 1, carry, 1
        if em >= rlen:              # no literal: the run code's width at pos0
            return runs, lits, pos0, ch.step(pos0, 0)[2]
    while True:
        w0 = pos

        def walk(i, start, tokc=None, emc=None):
            """Lane i from start=(pos, phase) to its end bit or cap codes:
            counting (R, E), or with tokc/emc given writing tokens; returns
            (exit state, R, E, end of the chain or None)."""
            p, ph = start
            r = e = 0
            for _ in range(cap):
                if p >= w0 + (i + 1) * lane_bits:
                    break
                if tokc is not None:
                    if ph == 0 and (tokc >= max_tokens or emc >= rlen):
                        break                       # past the chain's end
                    if ph == 1 and (emc >= rlen or tokc > max_tokens):
                        break
                val, p, lw = ch.step(p, ph)
                if ph == 0:
                    r, e = r + 1, e + val
                    if tokc is not None:
                        runs[tokc] = val
                        tokc, emc = tokc + 1, emc + val
                        if emc >= rlen:             # the last token: no literal
                            return (p, 1), r, e, (p, lw, tokc)
                else:
                    e += 1
                    if tokc is not None:
                        lits[tokc - 1] = val
                        emc += 1
                        if emc >= rlen or tokc >= max_tokens:
                            return (p, 0), r, e, (p, lw, tokc)
                ph ^= 1
            return (p, ph), r, e, None

        starts = [(pos, phase)] + [(w0 + i * lane_bits, 0) for i in range(1, lanes)]
        for _ in range(lanes + 1):                  # synchronise
            exits = [walk(i, starts[i])[0] for i in range(lanes)]
            new = [starts[0]] + exits[:-1]
            if new == starts:
                break
            starts = new
        assert new == starts, "the lanes did not settle within 32 rounds"
        counts = [walk(i, starts[i])[1:3] for i in range(lanes)]
        tb = np.concatenate([[0], np.cumsum([c[0] for c in counts])]) + tok
        eb = np.concatenate([[0], np.cumsum([c[1] for c in counts])]) + em
        for i in range(lanes):                      # the write pass
            end = walk(i, starts[i], int(tb[i]), int(eb[i]))[3]
            if end is not None:
                return runs, lits, end[0], end[1]
        pos, phase = exits[-1]
        tok, em = int(tb[-1]), int(eb[-1])


@functools.lru_cache(maxsize=None)
def _run_cases():
    return [c for c in decode_edge_cases("cpu", long_len=600, row_len=300)
            if c[1] == "decode_run"]


@pytest.mark.parametrize("cut", [1, 3])
@pytest.mark.parametrize("lane_bits", [32, 64])
@pytest.mark.parametrize("case", range(6))
def test_decode_run_warp_schedule(case, lane_bits, cut):
    """The six run-chain edge cases of testing.decode_edge_cases (runs over
    255 and 65,535, carry >= 0, type-2 escapes, fixed 8-bit codes, resumed
    8-bit chains, every code an escape), whole and cut to a third of their
    tokens, against decode2.run_chain."""
    label, _, args, kw, _ = _run_cases()[case]
    rect, rlens, f1r, f1s, f2, nsignal = args
    kw = dict(kw, max_tokens=kw["max_tokens"] // cut)
    runs, lits, bits, last = d2.run_chain(*args, **kw)
    n = rlens.shape[0]
    pos0 = kw["pos0"] if kw["pos0"] is not None else torch.zeros(n, dtype=torch.int32)
    carry = kw["carry"] if kw["carry"] is not None else torch.full((n,), -1)
    for r in range(n):
        ch = _Chain(rect[r].tolist(), f1r.tolist(), f1s.tolist(), f2.tolist(),
                    kw["subw"], kw["lmax"], nsignal)
        got = decode_run_warp(ch, int(rlens[r]), kw["max_tokens"], int(pos0[r]),
                              int(carry[r]), lane_bits)
        assert got[0] == runs[r].tolist(), (label, r)
        assert got[1] == lits[r].tolist(), (label, r)
        assert (got[2], got[3]) == (int(bits[r]), int(last[r])), (label, r)
