"""NumPy models of the work schedules of eight CUDA kernels, which cannot
run on this host: K8 ``pack_words`` as tiles of a row across blocks with a
decoupled look-back, K1 ``encode_plain``, K2 ``encode_run`` and K3
``pack_tags`` as warps over tiles of a row chained by the same look-back,
and K9 ``lut_gather`` as the tiles of up to eight lookups in one grid
(ops/csrc/emit.cu); K5 ``decode_run`` and K4 ``decode_plain`` as one warp
per chain, whose lanes speculate, synchronise, scan and write
(ops/csrc/decode.cu); K7 ``pack2bit`` as tiles of the flat payload, each
finding its reads by a search and staging its bases from an aligned start
(ops/csrc/twobit.cu).  Each model follows its kernel step by step at small
tile and lane sizes and is held against the kernel's plain twin."""

import functools

import numpy as np
import pytest
import torch

from dextractor_tpu_torch.ops import bitstream_torch as bt
from dextractor_tpu_torch.ops import decode2 as d2
from dextractor_tpu_torch.ops.twobit import NUMBER_BASE_LUT
from dextractor_tpu_torch.parallel.pipeline import _pack_tags
from dextractor_tpu_torch.testing import (EDGE_RCHAR, decode_edge_cases, encode_edge_rows,
                                          run_edge_rows)

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


# ---------------------------------------------------------------------------
# K4: one warp per (channel, chain)
# ---------------------------------------------------------------------------

_INF = 1 << 40      # the symbols of a lane that stalls on a 0-bit code


def decode_plain_warp(ch, rlen, max_len, pos0, lane_bits):
    """The K4 kernel's schedule for one plain chain (``ch``: a ``_Chain``
    read in its literal phase, whose escape is the plain signal): windows
    of 32 lanes of ``lane_bits`` bits, the window's words staged; lanes
    guess their first bit as a start, re-decode from their left
    neighbour's exit until no start up to the first stalled lane changes,
    scan their symbol counts and decode again to write.  A 0-bit code that
    is no escape stalls its lane: the serial chain repeats it to the end.
    Returns (syms, bits, last)."""
    lanes = 32
    n = max(0, min(rlen, max_len))
    out = np.zeros(max_len, np.int64)
    writes = np.zeros(max_len, np.int64)
    if n == 0:
        return out, pos0, 0
    pos, em = pos0, 0
    while True:
        w0, base = pos, pos >> 5

        def step(q):
            assert 0 <= (q >> 5) - base and (q >> 5) + 1 - base < lane_bits + 2, \
                "a read outside the window's staged words"
            return ch.step(q, 1)

        def walk(i, q):
            """Lane i from q to its end bit: (exit, symbols, stalled)."""
            c = 0
            while q < w0 + (i + 1) * lane_bits:
                _, q2, width = step(q)
                if width == 0:
                    return q, c, True
                q, c = q2, c + 1
            return q, c, False

        starts = [pos] + [w0 + i * lane_bits for i in range(1, lanes)]
        for _ in range(lanes + 1):                  # synchronise
            res = [walk(i, starts[i]) for i in range(lanes)]
            new = [starts[0]] + [r[0] for r in res[:-1]]
            stalls = [i for i, r in enumerate(res) if r[2]]
            s = stalls[0] if stalls else lanes - 1
            moved = new[:s + 1] != starts[:s + 1]
            starts = new
            if not moved:
                break
        assert not moved, "the lanes did not settle within 32 rounds"
        counts = [r[1] + (_INF if r[2] else 0) for r in res]
        excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        end = None
        for i in range(lanes):                      # the write pass
            ec, q = em + int(excl[i]), starts[i]
            while ec < n and q < w0 + (i + 1) * lane_bits:
                sym, q2, width = step(q)
                if width == 0:                      # the rest of the chain is sym
                    out[ec:n] = sym & 0xFF
                    writes[ec:n] += 1
                    end = (q, 0)
                    break
                out[ec] = sym & 0xFF
                writes[ec] += 1
                ec, q = ec + 1, q2
                if ec == n:
                    end = (q, width)
                    break
            if end is not None:
                break
        if end is not None:
            assert (writes[:n] == 1).all(), "a symbol written other than once"
            return out, end[0], end[1]
        pos, em = res[-1][0], em + sum(counts)


@functools.lru_cache(maxsize=None)
def _plain_cases():
    return [c for c in decode_edge_cases("cpu", long_len=600, row_len=300)
            if c[1] == "decode_plain"]


@pytest.mark.parametrize("lane_bits", [32, 64])
@pytest.mark.parametrize("case", range(6))
def test_decode_plain_warp_schedule(case, lane_bits):
    """The six plain edge cases of testing.decode_edge_cases (four schemes in
    one launch with type-2 escapes, L2 tables and 0-bit codes; lmax 12
    alone; resumed at pos0; every code 8 bits long, resumed too; every
    symbol an escape; a 600-symbol chain of 0-bit codes) against
    decode2.plain_chains: symbols, bits and last."""
    label, _, args, kw, _ = _plain_cases()[case]
    rects, rlens, f1, f2, sigs, subws = args
    syms, bits, last = d2.plain_chains(*args, **kw)
    pos0 = kw["pos0"]
    for c, rect in enumerate(rects):
        for r in range(rlens.shape[0]):
            ch = _Chain(rect[r].tolist(), f1[c].tolist(), f1[c].tolist(), f2.tolist(),
                        subws[c], kw["lmax"], sigs[c])
            got = decode_plain_warp(ch, int(rlens[r]), kw["max_len"],
                                    0 if pos0 is None else int(pos0[c, r]), lane_bits)
            assert got[0].tolist() == syms[c, r].tolist(), (label, c, r)
            assert (got[1], got[2]) == (int(bits[c, r]), int(last[c, r])), (label, c, r)


# ---------------------------------------------------------------------------
# K1: warps over tiles of a row
# ---------------------------------------------------------------------------

def _emission(pk, sym):
    """(value, width, last granule) of a symbol's packed LUT entry
    ``bits << 6 | len << 1 | esc``: an escape is code || the 8-bit symbol."""
    bits, ln = pk >> 6, (pk >> 1) & 31
    if pk & 1:
        return (bits << 8) | sym, ln + 8, 8
    return bits, ln, ln


def encode_plain_tiles(data, lengths, luts, tile, per_lane, rng):
    """The K1 kernel's schedule: each (channel, row) cut into tiles of
    ``tile`` symbols taken in ticket (row-major) order, one warp a tile,
    walked in steps of 32 lanes x ``per_lane`` consecutive symbols.  A tile
    past the row's length does nothing.  A tile that does not hold the
    row's last symbol first folds its (bit count, last <= 32 bits) and
    publishes it; a later tile looks back over the row's earlier tiles
    (each seen with its inclusive prefix or, at random, its aggregate).
    Each step: a warp scan of the lanes' widths gives each lane its bit
    offset, the lanes OR their words into a window whose word 0 holds the
    carried bits, the window's full words are stored and its partial last
    word carried; the row's last tile stores the partial last word and t,
    and the lane with symbol len - 1 lg.  Returns (words, t, lg) as the
    twin does, with words past ceil(t/32) zero; every word up to it is
    stored once, none past it."""
    c, n_rows, width = data.shape
    step = 32 * per_lane
    tpr = max(1, -(-width // tile))
    mp = width + 1
    out = np.zeros((c, n_rows, mp), np.int64)
    writes = np.zeros((c, n_rows, mp), np.int64)
    t_out = np.full((c, n_rows), -1, np.int64)
    lg_out = np.full((c, n_rows), -1, np.int64)
    agg, inc = {}, {}
    for ticket in range(c * n_rows * tpr):
        r, k = divmod(ticket, tpr)
        ch, row = divmod(r, n_rows)
        ln = max(0, min(int(lengths[row]), width))
        lo = k * tile
        if k > 0 and lo >= ln:
            continue
        hi = min(lo + tile, ln)
        last_tile = hi == ln
        lut = [int(x) for x in luts[ch]]
        ems = [_emission(lut[int(data[ch, row, j])], int(data[ch, row, j])) + (j,)
               for j in range(lo, hi)]
        excl = (0, 0)
        if not last_tile:
            pair = (0, 0)
            for v, w, _, _ in ems:
                pair = _combine(pair, (w, v))
            agg[ticket] = pair
            if k == 0:
                inc[ticket] = pair
        if k > 0:
            for j in range(k - 1, -1, -1):          # look back in the row
                t = r * tpr + j
                if t in inc and rng.random() < 0.5:
                    excl = _combine(inc[t], excl)
                    break
                excl = _combine(agg[t], excl)
            if not last_tile:
                inc[ticket] = _combine(excl, agg[ticket])
        bit = excl[0]
        o = bit & 31
        carry = (excl[1] << (32 - o)) & M32 if o else 0
        for s0 in range(lo, hi, step):
            lanes = [[e for e in ems if s0 + i * per_lane <= e[3] < s0 + (i + 1) * per_lane]
                     for i in range(32)]
            tots = [sum(e[1] for e in em) for em in lanes]
            offs = np.concatenate([[0], np.cumsum(tots)[:-1]])
            o = bit & 31
            step_bits = sum(tots)
            win = [0] * ((o + step_bits + 31) // 32 + 1)
            win[0] = carry
            for lane, em in enumerate(lanes):       # each lane's accumulator
                b = o + int(offs[lane])
                wi, fill, cur = b >> 5, b & 31, 0
                for v, w, g, j in em:
                    if j == ln - 1:
                        lg_out[ch, row] = g
                    if w == 0:
                        continue
                    room = 32 - fill
                    if w < room:
                        cur |= v << (room - w)
                        fill += w
                    else:
                        cur |= v >> (w - room)
                        win[wi] |= cur & M32
                        wi, fill = wi + 1, w - room
                        cur = (v << (32 - fill)) & M32 if fill else 0
                if fill:
                    win[wi] |= cur & M32
            full = (o + step_bits) >> 5
            for i in range(full):
                out[ch, row, (bit >> 5) + i] = win[i]
                writes[ch, row, (bit >> 5) + i] += 1
            carry = win[full] if (o + step_bits) & 31 else 0
            bit += step_bits
        if last_tile:
            if bit & 31:
                out[ch, row, bit >> 5] = carry
                writes[ch, row, bit >> 5] += 1
            t_out[ch, row] = bit
            if ln == 0:
                lg_out[ch, row] = 0
    raw = (t_out + 31) >> 5
    assert (t_out >= 0).all() and (lg_out >= 0).all()
    assert (writes == (np.arange(mp) < raw[..., None])).all(), \
        "a word stored other than once, or past ceil(t/32)"
    return out, t_out, lg_out


@functools.lru_cache(maxsize=None)
def _encode_rows():
    return encode_edge_rows(600)


@pytest.mark.parametrize("tile, per_lane", [(64, 1), (256, 4)])
@pytest.mark.parametrize("case", range(4))
def test_encode_plain_tile_schedule(case, tile, per_lane):
    """testing.encode_edge_rows at width 600 (rows of 0, 1, 31, 32, 33
    symbols and up to several tiles, type-2 escapes, codes of up to 16 bits,
    0-bit and 8-bit codes; all escapes; 0-bit codes only; a width of 595)
    against bitstream_torch.encode_plain_ref: words up to ceil(t/32), t,
    lg."""
    label, data, lengths, luts = _encode_rows()[case]
    words, t, lg = bt.encode_plain_ref(torch.from_numpy(data), torch.from_numpy(lengths),
                                       torch.from_numpy(luts))
    rng = np.random.default_rng(case * 7 + tile)
    gw, gt, glg = encode_plain_tiles(data, lengths, luts, tile, per_lane, rng)
    assert gt.tolist() == t.tolist() and glg.tolist() == lg.tolist(), label
    raw = (gt + 31) >> 5
    ref = np.where(np.arange(words.shape[2]) < raw[..., None],
                   words.numpy().astype(np.int64) & M32, 0)
    np.testing.assert_array_equal(gw, ref, err_msg=label)


# ---------------------------------------------------------------------------
# K2 and K3: K1's tiles for the RLE channels and for the delTag
# ---------------------------------------------------------------------------

def _put(win, b, v, w):
    """OR the w-bit value v into the MSB-first words win at bit b."""
    end = b + w
    for q in range(b >> 5, ((end - 1) >> 5) + 1) if w else ():
        shift = 32 * (q + 1) - end
        win[q] |= ((v << shift) if shift >= 0 else (v >> -shift)) & M32


def _run_code(pk, run):
    """(value, width, last granule) of the run code of ``run`` from the
    packed run-LUT entry of min(run, 255): an escape appends run & 0xFFFF."""
    bits, ln = pk >> 6, (pk >> 1) & 31
    if pk & 1:
        return (bits << 16) | (run & 0xFFFF), ln + 16, 16
    return bits, ln, ln


def _look_back(r, k, tpr, agg, inc, rng):
    """The exclusive prefix of tile k of row r: the row's earlier tiles
    folded, each seen with its inclusive prefix or, at random, its
    aggregate, up to the nearest inclusive prefix taken."""
    excl = (0, 0)
    for j in range(k - 1, -1, -1):
        t = r * tpr + j
        if t in inc and rng.random() < 0.5:
            return _combine(inc[t], excl)
        excl = _combine(agg[t], excl)
    return excl


def _lane_steps(lo, hi, step, per_lane):
    """The (step start, [(lane, columns)]) of a tile walked in warp steps."""
    for s0 in range(lo, hi, step):
        yield s0, [(i, range(s0 + i * per_lane, min(s0 + (i + 1) * per_lane, hi)))
                   for i in range(32)]


def encode_run_tiles(data, lengths, sym_luts, run_luts, rchars, tile, per_lane, rng):
    """The K2 kernel's schedule: K1's tiles and steps (``encode_plain_tiles``)
    over an RLE channel.  A tile that is not its row's last first finds its
    last literal, walking back from its last step, and publishes it; a later
    tile takes the row's last literal before it from the nearest earlier
    tile that has one.  Then the tiles fold, publish and look back over
    (bit count, last <= 32 bits) as K1's do.  In each step the lanes' last
    literals, max-scanned from the one carried, give each lane the literal
    before its symbols; a literal emits its run code, then its own code.
    The row's last tile emits the trailing run, stores the partial last
    word, t and lg.  Returns (words, t, lg) as the twin does, with words
    past ceil(t/32) zero; every word up to it is stored once, none past."""
    c, n_rows, width = data.shape
    step = 32 * per_lane
    tpr = max(1, -(-width // tile))
    mp = 2 * width + 2
    out = np.zeros((c, n_rows, mp), np.int64)
    writes = np.zeros((c, n_rows, mp), np.int64)
    t_out = np.full((c, n_rows), -1, np.int64)
    lg_out = np.full((c, n_rows), -1, np.int64)
    agg, inc, lits = {}, {}, {}
    for ticket in range(c * n_rows * tpr):
        r, k = divmod(ticket, tpr)
        ch, row = divmod(r, n_rows)
        ln = max(0, min(int(lengths[row]), width))
        lo = k * tile
        if k > 0 and lo >= ln:
            continue
        hi = min(lo + tile, ln)
        last_tile = hi == ln
        d = [int(x) for x in data[ch, row, lo:hi]]
        rchar = int(rchars[ch])
        slut = [int(x) for x in sym_luts[ch]]
        rlut = [int(x) for x in run_luts[ch]]
        lit_cols = [lo + j for j, s in enumerate(d) if s != rchar]
        if not last_tile:                          # walk back from the last step
            tl, s0 = -1, lo + (hi - lo - 1) // step * step
            while s0 >= lo and tl < 0:
                tl = max((j for j in lit_cols if s0 <= j < s0 + step), default=-1)
                s0 -= step
            lits[ticket] = tl
        excl_lit = next((lits[r * tpr + j] for j in range(k - 1, -1, -1)
                         if lits[r * tpr + j] >= 0), -1)

        def lane_emissions(prev, cols):
            """(emissions [(v, w)], last literal) of a lane's columns."""
            ems = []
            for j in cols:
                if d[j - lo] != rchar:
                    run = j - prev - 1
                    ems.append(_run_code(rlut[min(run, 255)], run)[:2])
                    ems.append(_emission(slut[d[j - lo]], d[j - lo])[:2])
                    prev = j
            return ems, prev

        def steps():
            """Each step's lanes' emissions, from the scan of last literals."""
            prev = excl_lit
            for s0, lanes in _lane_steps(lo, hi, step, per_lane):
                mx = [max((j for j in cols if d[j - lo] != rchar), default=-1)
                      for _, cols in lanes]
                before = np.maximum.accumulate([prev] + mx)  # exclusive, seeded
                yield s0, [lane_emissions(int(before[i]), cols)[0] for i, cols in lanes]
                prev = int(before[-1])

        excl = (0, 0)
        if not last_tile:
            pair = (0, 0)
            for _, lanes in steps():
                for ems in lanes:
                    for v, w in ems:
                        pair = _combine(pair, (w, v))
            agg[ticket] = pair
            if k == 0:
                inc[ticket] = pair
        if k > 0:
            excl = _look_back(r, k, tpr, agg, inc, rng)
            if not last_tile:
                inc[ticket] = _combine(excl, agg[ticket])
        bit = excl[0]
        o = bit & 31
        carry = (excl[1] << (32 - o)) & M32 if o else 0
        for _, lanes in steps():
            tots = [sum(w for _, w in ems) for ems in lanes]
            o, step_bits = bit & 31, sum(tots)
            win = [0] * ((o + step_bits + 31) // 32 + 2)
            win[0] = carry
            b = o
            for ems, tot in zip(lanes, tots):
                for v, w in ems:
                    _put(win, b, v, w)
                    b += w
            full = (o + step_bits) >> 5
            for i in range(full):
                out[ch, row, (bit >> 5) + i] = win[i]
                writes[ch, row, (bit >> 5) + i] += 1
            carry = win[full] if (o + step_bits) & 31 else 0
            bit += step_bits
        if last_tile:
            last_lit = max([excl_lit] + lit_cols)
            trail = ln - last_lit - 1
            tv, tn, lg = 0, 0, 0
            if trail > 0:
                tv, tn, lg = _run_code(rlut[min(trail, 255)], trail)
            elif ln > 0:
                lg = _emission(slut[d[-1]], d[-1])[2]
            win = [carry, 0]
            _put(win, bit & 31, tv, tn)
            for i in range(((bit & 31) + tn + 31) >> 5):
                out[ch, row, (bit >> 5) + i] = win[i]
                writes[ch, row, (bit >> 5) + i] += 1
            t_out[ch, row], lg_out[ch, row] = bit + tn, lg
    raw = (t_out + 31) >> 5
    assert (t_out >= 0).all() and (lg_out >= 0).all()
    assert (writes == (np.arange(mp) < raw[..., None])).all(), \
        "a word stored other than once, or past ceil(t/32)"
    return out, t_out, lg_out


def pack_tags_tiles(tags, dels, lengths, del_char, number_lut, tile, per_lane, rng):
    """The K3 kernel's schedule: K1's tiles and steps over the delTag rows.
    A lane keeps the tags whose delQV byte is not del_char (all when it is
    negative); a scan of the lanes' counts places each lane's 2-bit codes
    at bit 2 * rank of a window of big-endian words, whose finished words
    are stored as four bytes each.  The tiles chain by the look-back over
    (2 * kept, last <= 32 bits); the row's last tile stores the partial
    word's bytes, clens and zeros up to ceil(L/4).  Returns (packed,
    clens); every byte of every row is stored exactly once."""
    n_rows, width = tags.shape
    step = 32 * per_lane
    tpr = max(1, -(-width // tile))
    wb = (width + 3) // 4
    out = np.zeros((n_rows, wb), np.int64)
    writes = np.zeros((n_rows, wb), np.int64)
    clens = np.full(n_rows, -1, np.int64)
    lut = [int(x) & 3 for x in number_lut]
    agg, inc = {}, {}
    for ticket in range(n_rows * tpr):
        row, k = divmod(ticket, tpr)
        ln = max(0, min(int(lengths[row]), width))
        lo = k * tile
        if k > 0 and lo >= ln:
            continue
        hi = min(lo + tile, ln)
        last_tile = hi == ln
        code = {j: lut[int(tags[row, j])] for j in range(lo, hi)
                if del_char < 0 or int(dels[row, j]) != del_char}
        excl = (0, 0)
        if not last_tile:
            pair = (0, 0)
            for cd in code.values():
                pair = _combine(pair, (2, cd))
            agg[ticket] = pair
            if k == 0:
                inc[ticket] = pair
        if k > 0:
            excl = _look_back(row, k, tpr, agg, inc, rng)
            if not last_tile:
                inc[ticket] = _combine(excl, agg[ticket])
        bit = excl[0]
        o = bit & 31
        carry = (excl[1] << (32 - o)) & M32 if o else 0
        for _, lanes in _lane_steps(lo, hi, step, per_lane):
            kept = [[code[j] for j in cols if j in code] for _, cols in lanes]
            o, step_bits = bit & 31, 2 * sum(map(len, kept))
            win = [0] * ((o + step_bits + 31) // 32 + 2)
            win[0] = carry
            p = o
            for codes in kept:                      # a lane's codes at 2 * rank
                v = 0
                for cd in codes:
                    v = (v << 2) | cd
                _put(win, p, v, 2 * len(codes))
                p += 2 * len(codes)
            full = (o + step_bits) >> 5
            for i in range(full):
                b0 = 4 * ((bit >> 5) + i)
                out[row, b0:b0 + 4] = [(win[i] >> s) & 0xFF for s in (24, 16, 8, 0)]
                writes[row, b0:b0 + 4] += 1
            carry = win[full] if (o + step_bits) & 31 else 0
            bit += step_bits
        if last_tile:
            clens[row] = bit >> 1
            b0 = 4 * (bit >> 5)
            tail = [(carry >> s) & 0xFF for s in (24, 16, 8, 0)] + [0] * wb
            out[row, b0:] = tail[:wb - b0]
            writes[row, b0:] += 1
    assert (clens >= 0).all()
    assert (writes == 1).all(), "a byte stored other than once"
    return out, clens


@functools.lru_cache(maxsize=None)
def _run_rows():
    return run_edge_rows(1200)


@pytest.mark.parametrize("tile, per_lane", [(64, 1), (256, 4)])
@pytest.mark.parametrize("case", range(2))
def test_encode_run_tile_schedule(case, tile, per_lane):
    """testing.run_edge_rows at widths 1,200 and 1,195 (rows of 0-33
    symbols, no literal, literals only at the ends, runs of 255 and 256 and
    across tiles, all literals; four scheme pairs with escapes, 0-bit codes
    and 16-bit run literals) against bitstream_torch.encode_run_ref: words
    up to ceil(t/32), t, lg."""
    label, data, lengths, sym, run, rchars, _ = _run_rows()[case]
    words, t, lg = bt.encode_run_ref(*(torch.from_numpy(a)
                                       for a in (data, lengths, sym, run, rchars)))
    rng = np.random.default_rng(case * 11 + tile)
    gw, gt, glg = encode_run_tiles(data, lengths, sym, run, rchars, tile, per_lane, rng)
    assert gt.tolist() == t.tolist() and glg.tolist() == lg.tolist(), label
    raw = (gt + 31) >> 5
    ref = np.where(np.arange(words.shape[2]) < raw[..., None],
                   words.numpy().astype(np.int64) & M32, 0)
    np.testing.assert_array_equal(gw, ref, err_msg=label)


@pytest.mark.parametrize("tile, per_lane", [(64, 1), (256, 4)])
@pytest.mark.parametrize("del_char", [EDGE_RCHAR, -1])
@pytest.mark.parametrize("case", range(2))
def test_pack_tags_tile_schedule(case, del_char, tile, per_lane):
    """testing.run_edge_rows' tags and delQV rows at widths 1,200 and 1,195
    (no tag kept, every tag kept, rows of 0-33 symbols) with delChar and
    with -1 against parallel.pipeline._pack_tags: every byte, clens."""
    label, data, lengths, _, _, _, tags = _run_rows()[case]
    dels = np.ascontiguousarray(data[0])
    ref_p, ref_c = _pack_tags(torch.from_numpy(tags), torch.from_numpy(dels),
                              torch.from_numpy(lengths),
                              torch.tensor([del_char], dtype=torch.int32),
                              torch.from_numpy(NUMBER_BASE_LUT))
    rng = np.random.default_rng(case * 13 + tile)
    got_p, got_c = pack_tags_tiles(tags, dels, lengths, del_char, NUMBER_BASE_LUT, tile,
                                   per_lane, rng)
    assert got_c.tolist() == ref_c.tolist(), label
    np.testing.assert_array_equal(got_p, ref_p.numpy().astype(np.int64), err_msg=label)


# ---------------------------------------------------------------------------
# K7: tiles of the flat payload, the tile's reads found around an estimate
# (else by a k-ary search), its bases staged as 2-bit codes from a 16-byte
# aligned start
# ---------------------------------------------------------------------------

def _kary_read(ends, n, j, probes):
    """kary_reads: the largest r in [0, n) with ends[r] <= j, by rounds of
    ``probes`` evenly spaced probes, as the block's threads search."""
    lo, hi = 0, n
    while hi - lo > 1:
        s = -(-(hi - lo) // probes)
        c = sum(1 for t in range(probes)
                if t == 0 or (lo + t * s < hi and ends[lo + t * s] <= j))
        lo += (c - 1) * s
        hi = min(lo + s, hi)
    return lo


def _tile_reads(ends, n, n_out, ja, jb, probes, seen):
    """tile_reads: ra and rb, from windows of ``probes`` reads around each
    byte's estimated read where both windows hold their read, else from the
    k-ary search; ``seen`` counts the two outcomes."""
    top = max(n - probes, 0)

    def window(j):
        return min(max(int(j / n_out * n) - probes // 2, 0), top)

    found = []
    for j in (ja, jb):
        g = window(j)
        c = sum(1 for t in range(probes) if g + t < n and ends[g + t] <= j)
        found.append((g + c - 1) if c >= 1 and (c < probes or g + probes >= n) else None)
    if None in found:
        seen["k-ary"] += 1
        found = [_kary_read(ends, n, j, probes) for j in (ja, jb)]
    else:
        seen["window"] += 1
    for r, j in zip(found, (ja, jb)):
        assert r == np.searchsorted(ends[:n], j, "right") - 1
    return found


def _read_at(ends, lo, hi, j):
    """read_at: the largest r in [lo, hi] with ends[r] <= j, binary."""
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if ends[mid] <= j:
            lo = mid
        else:
            hi = mid - 1
    return lo


def pack2bit_tiles(flat, offs, couts, lut, tile, threads, addr0, rng, seen):
    """The K7 kernel's schedule: a block a tile of ``tile`` payload bytes and
    16 bytes a thread (``threads`` = tile // 16, also the probes of the
    search); the tile's first and last reads by ``_tile_reads``; its bases
    read in 16-byte chunks from their span's start aligned down to 16 bytes
    (``addr0``: the address of flat[0] mod 16; bytes outside the buffer are
    garbage) and kept as words of 16 two-bit codes, MSB-first; each thread
    finds its first byte's read by ``_read_at`` between the tile's two reads
    and takes four bytes of one read from one 32-bit funnel shift of two
    code words where they lie inside the read, else goes byte by byte: it
    searches again where it crosses into a later read and masks the codes
    past the read.  Every payload byte must be written once."""
    offs, couts = np.asarray(offs).tolist(), np.asarray(couts).tolist()
    n, n_out = len(offs) - 1, couts[-1]
    assert tile == 16 * threads
    tab = [int(v) & 3 for v in lut]
    out = np.full(n_out, -1, np.int64)
    for j0 in range(0, n_out, tile):
        j1 = min(j0 + tile, n_out)
        ra, rb = _tile_reads(couts, n, n_out, j0, j1 - 1, threads, seen)
        in_lo = offs[ra] + 4 * (j0 - couts[ra])
        in_hi = min(offs[rb] + 4 * (j1 - couts[rb]), offs[rb + 1])
        assert in_hi - in_lo <= 4 * tile
        origin = in_lo - ((addr0 + in_lo) & 15)
        chunks = -(-(in_hi - origin) // 16)
        staged = rng.integers(0, 256, 16 * chunks)          # garbage past the buffer
        lo, hi = max(origin, 0), min(origin + 16 * chunks, len(flat))
        staged[lo - origin:hi - origin] = flat[lo:hi]
        code = [0] * (chunks + 2)                            # a word past them: garbage
        code[-2:] = rng.integers(0, 1 << 32, 2).tolist()
        for c in range(chunks):
            for b in staged[16 * c:16 * c + 16]:
                code[c] = code[c] * 4 + tab[b]

        def codes16(p):
            c, sh = p >> 4, 2 * (p & 15)
            return ((code[c] << sh) | (code[c + 1] >> (32 - sh))) & M32 if sh else code[c]

        span_end = in_hi - origin
        for t in range(threads):
            jt = 16 * t
            if j0 + jt >= j1:
                continue
            nb = min(16, j1 - j0 - jt)

            def bounds(r):
                lim = min(offs[r + 1] - origin, span_end)
                return offs[r] - origin - 4 * (couts[r] - j0), lim, min(couts[r + 1], j1) - j0

            r = _read_at(couts, ra, rb, j0 + jt)
            x0, lim, e = bounds(r)
            x = x0 + 4 * jt
            got = []
            for g in range(4):
                if 4 * g + 4 <= nb and x + 16 <= lim:
                    got += [(codes16(x) >> (24 - 8 * k)) & 255 for k in range(4)]
                    x += 16
                    continue
                for i in range(4 * g, min(4 * g + 4, nb)):
                    if jt + i >= e:
                        r = _read_at(couts, r + 1, rb, j0 + jt + i)
                        x0, lim, e = bounds(r)
                        x = x0 + 4 * (jt + i)
                    b = codes16(x) >> 24
                    if lim - x < 4:
                        b &= (0xFF00 >> (2 * (lim - x))) & 0xFF
                    got.append(b)
                    x += 4
            assert (out[j0 + jt:j0 + jt + nb] == -1).all()
            out[j0 + jt:j0 + jt + nb] = got
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("addr0", [0, 9])
@pytest.mark.parametrize("tile, threads", [(64, 4), (256, 16)])
@pytest.mark.parametrize("case", range(6))
def test_pack2bit_tile_schedule(case, tile, threads, addr0):
    """testing.twobit_tile_edges at tiles of 64 and 256 bytes (reads of 0-7
    bases, thousands of empty reads inside a tile, reads that end at tile
    boundaries, a read longer than two tiles, many short reads a tile, reads
    whose first base is off 16-byte alignment), with the buffer itself at
    an aligned address and 9 bytes past one, and a random table, against
    ops.twobit.pack2bit_twin: every payload byte."""
    from dextractor_tpu_torch.ops.twobit import pack2bit_twin
    from dextractor_tpu_torch.testing import twobit_tile_edges

    label, flat, lengths, lead = twobit_tile_edges(tile)[case]
    rng = np.random.default_rng(case + tile + addr0)
    lut = rng.integers(0, 4, 256).astype(np.uint8)
    offs = lead + np.concatenate([[0], np.cumsum(lengths)])
    couts = np.concatenate([[0], np.cumsum((lengths + 3) >> 2)])
    ref = pack2bit_twin(torch.from_numpy(flat[lead:]), torch.from_numpy(lengths),
                        torch.from_numpy(lut)).numpy()
    seen = {"window": 0, "k-ary": 0}
    got = pack2bit_tiles(flat, offs, couts, lut, tile, threads, addr0, rng, seen)
    np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=label)
    if case == 1:   # thousands of empty reads: the windows miss
        assert seen["k-ary"]
    if case == 5:   # three reads: one window holds them all
        assert seen["window"] and not seen["k-ary"]


# ---------------------------------------------------------------------------
# K9: the tiles of up to eight lookups in one grid
# ---------------------------------------------------------------------------

def lut_gather_group_tiles(groups, luts, tile, threads):
    """The K9 kernel's schedule: block b belongs to the group g with
    first[g] <= b < first[g + 1], ``first`` the exclusive prefix of the
    groups' tile counts; a whole tile of a group whose data and output are
    aligned (``groups``: (data, table, aligned)) is quads strided by the
    block's threads, the tail tile or an unaligned group one element a
    thread and step.  Every element must be written once."""
    first = [0]
    for data, _, _ in groups:
        first.append(first[-1] + -(-data.size // tile))
    outs = [np.full(data.size, -1, np.int64) for data, _, _ in groups]
    for b in range(first[-1]):
        g = 0
        while g + 1 < len(groups) and first[g + 1] <= b:
            g += 1
        data, k, aligned = groups[g]
        table = luts[k].astype(np.int64)
        lo = (b - first[g]) * tile
        hi = min(lo + tile, data.size)
        if aligned and hi - lo == tile:
            idx = [4 * (lo // 4 + t + q * threads) + e for t in range(threads)
                   for q in range(tile // (4 * threads)) for e in range(4)]
        else:
            idx = [i for t in range(threads) for i in range(lo + t, hi, threads)]
        idx = np.array(idx, np.int64)
        assert (outs[g][idx] == -1).all() and ((idx >= lo) & (idx < hi)).all()
        outs[g][idx] = table[data.reshape(-1)[idx].astype(np.int64) & 255]
    assert all((o >= 0).all() for o in outs)
    return outs


@pytest.mark.parametrize("tile, threads", [(64, 4), (256, 16)])
def test_lut_gather_group_schedule(tile, threads):
    """Eight groups in one grid: 0 elements, one element, an unaligned start
    (scalar path), u8 and int32 mixed, whole tiles and tails, against
    bitstream_torch.lut_gather_plain group by group."""
    rng = np.random.default_rng(tile)
    luts = rng.integers(0, 1 << 30, (4, 256)).astype(np.int32)

    def data(n, dtype):
        return rng.integers(0, 256, n).astype(dtype)

    groups = [(data(0, np.uint8), 0, True), (data(1, np.int32), 1, True),
              (data(3 * tile + 5, np.uint8), 2, True), (data(2 * tile, np.int32), 3, False),
              (data(tile + 1, np.uint8), 0, False), (data(tile, np.int32), 1, True),
              (data(0, np.int32), 2, False), (data(5 * tile // 2, np.uint8).reshape(5, -1), 3, True)]
    got = lut_gather_group_tiles(groups, luts, tile, threads)
    for (d, k, _), out in zip(groups, got):
        ref = bt.lut_gather_plain(torch.from_numpy(d), torch.from_numpy(luts[k]))
        np.testing.assert_array_equal(out, ref.numpy().reshape(-1).astype(np.int64))


# ---------------------------------------------------------------------------
# The 2-bit unpack: warp tiles of the flat letter output, the tile's reads
# from a window of offsets a read a lane (else a k-ary search), 16 letters a
# group from one funnel shift of two payload words and four byte permutations
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel):
    """__byte_perm: output byte i is byte (sel >> 4i) & 7 of y:x."""
    b = (x & M32) | ((y & M32) << 32)
    return sum(((b >> (8 * ((sel >> (4 * i)) & 7))) & 255) << (8 * i) for i in range(4))


def _brev(x):
    return int(f"{x & M32:032b}"[::-1], 2)


def _spread(h):
    """Sixteen bits of 2-bit fields to nibbles, field i in nibble i."""
    h = (h | (h << 8)) & 0x00FF00FF
    h = (h | (h << 4)) & 0x0F0F0F0F
    return (h | (h << 2)) & 0x33333333


def unpack2bit_warp_tiles(payload, pay_offs, out_offs, lut, lanes, groups, addr0, rng, seen):
    """The unpack kernel's schedule: a warp a tile of 16 * lanes * groups
    letters, groups of 16 letters (one 16-byte store), ``groups`` a lane,
    ``lanes`` groups apart.  The warp loads the letter and payload offsets
    of a window of ``lanes`` reads around the estimated read of its first
    letter (reads past the last read n_out); where the window holds the
    reads of the tile's first and last letters, each group finds its read
    by a binary search of the lanes' offsets (shuffles), else the tile's
    two reads come from a k-ary search of all reads with ``lanes`` probes a
    round and each group searches between them (``_read_at``).  A group of
    16 letters of one read takes its codes from the aligned 32-bit word
    that holds their first payload byte and the next one (``addr0``: the
    address of payload[0] mod 16; bytes outside the buffer are garbage, and
    the next word is read only when it holds some of the codes), bit-
    reversed, spread to selector nibbles and looked up by four byte
    permutations of the letter table with each code's two bits swapped;
    else it goes letter by letter, a payload byte each, and searches again
    where it crosses into a later read.  Every letter must be written
    once."""
    pay_offs, out_offs = np.asarray(pay_offs).tolist(), np.asarray(out_offs).tolist()
    n, n_out = len(out_offs) - 1, out_offs[-1]
    wtile = 16 * lanes * groups
    lut32 = sum(int(v) << (8 * i) for i, v in enumerate(lut))
    lut_sw = _byte_perm(lut32, 0, 0x3120)
    out = np.full(n_out, -1, np.int64)
    garbage = {}

    def byte(a):   # the byte at address a (payload[0] at addr0)
        i = a - addr0
        if 0 <= i < len(payload):
            return int(payload[i])
        return garbage.setdefault(a, int(rng.integers(0, 256)))

    def word(a):   # the aligned 32-bit word at a, its first byte in bits 31-24
        assert a % 4 == 0
        return (byte(a) << 24) | (byte(a + 1) << 16) | (byte(a + 2) << 8) | byte(a + 3)

    def read_codes(src, q, k):
        """16 codes of a read from its code q on, of which the first k are
        the read's (its payload from src); the next word only where it holds
        some of those k."""
        at = addr0 + src + (q >> 2)
        sh = 8 * (at & 3) + 2 * (q & 3)
        hi = word(at & ~3)
        lo = 0
        if sh + 2 * k > 32:
            # the next word holds the last of the k codes: a byte of the read
            assert (at & ~3) + 4 <= addr0 + src + ((q + k - 1) >> 2)
            lo = word((at & ~3) + 4)
        return (((hi << 32) | lo) >> (32 - sh)) & M32

    for j0 in range(0, n_out, wtile):
        j1 = min(j0 + wtile, n_out)
        top = max(n - lanes, 0)
        g = min(max(int(j0 / n_out * n) - lanes // 2, 0), top)
        for attempt in range(2):
            e = [out_offs[min(g + i, n)] for i in range(lanes)]
            p = [pay_offs[min(g + i, n)] for i in range(lanes)]
            e_next = out_offs[min(g + lanes, n)]
            na = sum(v <= j0 for v in e)
            nb = sum(v <= j1 - 1 for v in e)
            win = na >= 1 and (nb < lanes or e_next > j1 - 1)
            if win or attempt:
                break
            seen["second windows"] += 1
            if na == 0:
                g = int(j0 / e[0] * g) - lanes // 2
            elif na < lanes:
                g = g + na - 1
            else:
                g = g + lanes - 1 + int((j0 - e[-1]) / (n_out - e[-1]) * (n - g - lanes + 1)) \
                    - lanes // 2
            g = min(max(g, 0), top)
        if win:
            seen["window"] += 1
            ra, rb = g + na - 1, g + nb - 1
        else:
            seen["k-ary"] += 1
            ra, rb = (_kary_read(out_offs, n, j, lanes) for j in (j0, j1 - 1))
        for lane in range(lanes):
            for gi in range(groups):
                jg = j0 + 16 * (lane + lanes * gi)
                if jg >= j1:
                    continue
                o2 = src1 = None
                if win:
                    lo, hi = na - 1, nb - 1
                    for _ in range((nb - na).bit_length()):
                        mid = (lo + hi + 1) >> 1
                        if e[mid] <= jg:
                            lo = mid
                        else:
                            hi = mid - 1
                    assert lo == hi
                    r, o, src = g + lo, e[lo], p[lo]
                    o1 = e[lo + 1] if lo < lanes - 1 else e_next
                    if lo < lanes - 1:
                        src1 = p[lo + 1]
                        o2 = e[lo + 2] if lo < lanes - 2 else e_next
                else:
                    r = _read_at(out_offs, ra, rb, jg)
                    o, o1, src = out_offs[r], out_offs[r + 1], pay_offs[r]
                assert o <= jg < o1 and r == np.searchsorted(out_offs[:n], jg, "right") - 1
                nl = min(16, j1 - jg)
                ka = min(o1 - jg, 16)
                if nl == 16 and (ka == 16 or (o2 is not None and o2 - jg >= 16)):
                    c = read_codes(src, jg - o, ka)
                    if ka < 16:
                        keep = M32 >> (2 * ka)
                        c = (c & ~keep & M32) | (read_codes(src1, 0, 16 - ka) >> (2 * ka))
                    c16 = _brev(c)
                    lo16, hi16 = _spread(c16 & 0xFFFF), _spread(c16 >> 16)
                    w = [_byte_perm(lut_sw, 0, s) for s in (lo16, lo16 >> 16, hi16, hi16 >> 16)]
                    got = [(w[i >> 2] >> (8 * (i & 3))) & 255 for i in range(16)]
                    seen["groups of two reads"] += ka < 16
                else:
                    got = []
                    for i in range(nl):
                        jl = jg + i
                        if jl >= o1:
                            r = _read_at(out_offs, r + 1, rb, jl)
                            o, o1, src = out_offs[r], out_offs[r + 1], pay_offs[r]
                        q = jl - o
                        got.append(int(lut[(int(payload[src + (q >> 2)]) >> (6 - 2 * (q & 3))) & 3]))
                assert (out[jg:jg + nl] == -1).all()
                out[jg:jg + nl] = got
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("addr0", [0, 9])
@pytest.mark.parametrize("lanes, groups", [(4, 1), (8, 2)])
@pytest.mark.parametrize("case", range(7))
def test_unpack2bit_tile_schedule(case, lanes, groups, addr0):
    """testing.twobit_letter_tile_edges at warp tiles of 64 and 256 letters
    (reads of 0-7 letters, thousands of empty reads inside a tile, reads
    that end at tile boundaries, a read longer than two tiles, reads of one
    letter, payloads 1, 13 and 15 bytes into their buffer), with the buffer
    at an aligned address and 9 bytes past one, and a random letter table,
    against ops.twobit.unpack2bit_twin: every letter."""
    from dextractor_tpu_torch.ops.twobit import unpack2bit_twin
    from dextractor_tpu_torch.testing import twobit_letter_tile_edges

    tile = 16 * lanes * groups
    label, payload, lengths, lead = twobit_letter_tile_edges(tile)[case]
    rng = np.random.default_rng(case + tile + addr0)
    lut = rng.integers(0, 256, 4).astype(np.uint8)
    pay_offs = lead + np.concatenate([[0], np.cumsum((lengths + 3) >> 2)])
    out_offs = np.concatenate([[0], np.cumsum(lengths)])
    ref = unpack2bit_twin(torch.from_numpy(payload[lead:]), torch.from_numpy(lengths),
                          torch.from_numpy(lut)).numpy()
    seen = {"window": 0, "k-ary": 0, "groups of two reads": 0, "second windows": 0}
    got = unpack2bit_warp_tiles(payload, pay_offs, out_offs, lut, lanes, groups, addr0, rng,
                                seen)
    np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=label)
    if case in (1, 4):   # thousands of empty reads, reads of one letter: windows miss
        assert seen["k-ary"] and seen["second windows"]
    if case == 6:        # reads of ~2,000 letters: every window holds its tile
        assert seen["window"] and not seen["k-ary"] and seen["groups of two reads"]


# ---------------------------------------------------------------------------
# K6: slices of a row's tokens a warp, several warps a row chained by a scan
# of the slices' sums, each slice's columns built in windows and written once
# ---------------------------------------------------------------------------

def expand_runs_windows(runs, lits, rchar, max_len, tag_bytes, row_warps, lanes,
                        lane_tokens, win, cap=1 << 30):
    """The K6 kernel's schedule: ``row_warps`` warps a row of ``lanes`` lanes;
    a round gives each warp a slice of lanes * lane_tokens tokens,
    ``lane_tokens`` consecutive ones a lane (with their lane_tokens / 4 tag
    bytes, 0 past the row's); a warp scan of the lanes' run sums and the
    sums of the round's earlier slices give the slice's first column; a
    round that starts at or past max_len ends the row.  Token k owns the
    columns [cumsum(runs)[k-1] + k, cumsum(runs)[k] + k], so a slice owns
    one span of columns, which its warp builds in windows of ``win``
    columns (rchar and -1, then the literals and tag letters) and writes
    once; the columns past the last token's are split among the row's
    warps in parts of a multiple of 16.  Run sums stop at ``cap`` (>=
    max_len and the token count), as the kernel's 32-bit sums stop at
    2^30.  Every column must be written once."""
    assert max_len <= cap and runs.shape[1] <= cap

    def add(x, y):
        return min(x + y, cap)

    n, t = runs.shape
    wt = lanes * lane_tokens
    rows = np.full((n, max_len), -1, np.int64)
    tags = None if tag_bytes is None else np.full((n, max_len), -2, np.int64)
    tw = 0 if tag_bytes is None else tag_bytes.shape[1]
    letters = b"acgt"

    def put(r, c0, vals, tvals):
        assert (rows[r, c0:c0 + len(vals)] == -1).all()
        rows[r, c0:c0 + len(vals)] = vals
        if tags is not None:
            tags[r, c0:c0 + len(vals)] = tvals

    for r in range(n):
        carry, k0 = 0, 0
        while k0 < t:
            if carry + k0 >= max_len:
                break
            lane_runs, sums = [], []
            for part in range(row_warps):
                ks = [k0 + part * wt + lane * lane_tokens for lane in range(lanes)]
                lr = [[min(int(runs[r, k + i]), cap) if k + i < t else 0
                       for i in range(lane_tokens)] for k in ks]
                lane_runs.append((ks, lr))
                sums.append(functools.reduce(add, [functools.reduce(add, x, 0) for x in lr], 0))
            for part, (ks, lr) in enumerate(lane_runs):
                before = functools.reduce(add, sums[:part], carry)
                a = k0 + part * wt
                if a >= t:
                    continue
                b = min(a + wt, t)
                lo, hi = before + a, min(add(before, sums[part]) + b, max_len)
                excl = [0]
                for x in lr:
                    excl.append(add(excl[-1], functools.reduce(add, x, 0)))
                for c0 in range(lo, hi, win):
                    m = min(hi - c0, win)
                    buf, tbuf = [rchar & 0xFF] * m, [-1] * m
                    for lane, k in enumerate(ks):
                        code = 0
                        for j in range(lane_tokens // 4):
                            code = (code << 8) | (int(tag_bytes[r, (k >> 2) + j])
                                                  if tw and (k >> 2) + j < tw else 0)
                        col = add(before, excl[lane])
                        for i in range(lane_tokens):
                            col = add(col, lr[lane][i])
                            x = col + k + i - c0
                            lit = int(lits[r, k + i]) if k + i < t else -1
                            if lit >= 0 and 0 <= x < m:
                                buf[x] = lit & 0xFF
                                sh = 2 * (lane_tokens - 1 - i)
                                tbuf[x] = letters[(code >> sh) & 3]
                    put(r, c0, buf, tbuf)
            carry = functools.reduce(add, sums, carry)
            k0 += row_warps * wt
        tail = carry + min(k0, t)
        if tail < max_len:
            per = -(-(-(-(max_len - tail) // row_warps)) // 16) * 16
            for part in range(row_warps):
                f, to = tail + part * per, min(tail + (part + 1) * per, max_len)
                if f < to:
                    put(r, f, [rchar & 0xFF] * (to - f), [-1] * (to - f))
    assert (rows >= 0).all() and (tags is None or (tags >= -1).all())
    return rows, tags


@functools.lru_cache(maxsize=None)
def _expand_cases():
    from dextractor_tpu_torch.testing import expand_edge_cases

    return expand_edge_cases(1200)


@pytest.mark.parametrize("row_warps, lanes, lane_tokens, win, cap", [
    (1, 4, 4, 64, 1 << 30), (1, 8, 8, 256, 5000), (3, 4, 4, 64, 5000),
    (3, 4, 8, 256, 1 << 30)])
@pytest.mark.parametrize("case", range(5))
def test_expand_runs_window_schedule(case, row_warps, lanes, lane_tokens, win, cap):
    """testing.expand_edge_cases at width 1,200 (the tokens of
    run_edge_rows' delQV rows: rows of 0-33 symbols, no literal, literals
    only at the ends, runs of 255/256, dense rows; with tag bytes that stop
    short of the tokens, without tags, at max_len 1,163 with literals past
    it and an odd token count; sparse rows of 4,800 symbols over many
    windows; runs up to 2^31 - 1) with one warp a row and three, windows of
    64 and 256 columns, run sums that stop at 2^30 and at 5,000, against
    ops.expand.expand_runs_ref: every row and tag column."""
    from dextractor_tpu_torch.ops.expand import expand_runs_ref

    label, runs, lits, rchar, max_len, tb = _expand_cases()[case]
    ref_r, ref_t = expand_runs_ref(torch.from_numpy(runs), torch.from_numpy(lits), rchar,
                                   max_len=max_len,
                                   tag_bytes=None if tb is None else torch.from_numpy(tb))
    got_r, got_t = expand_runs_windows(runs, lits, rchar, max_len, tb, row_warps, lanes,
                                       lane_tokens, win, cap)
    np.testing.assert_array_equal(got_r, ref_r.numpy().astype(np.int64), err_msg=label)
    if tb is None:
        assert ref_t is None and got_t is None
    else:
        np.testing.assert_array_equal(got_t, ref_t.numpy().astype(np.int64), err_msg=label)
