"""The benchmark's inputs: .quiva files drawn from a configuration and a seed.

A configuration (``portbench/configs/<name>.json``) fixes the reads of
each file of a run: their lengths (drawn once from its own
``lengths.seed``) and every QV value in them (drawn from that seed and the
file's index), from the distribution of every channel.  A run's ``--seed``
draws, for each of its files, the order of those reads and the headers;
so every seed codes the same reads with the same coding tables, in
another order.  Values drawn by the seed slowed the segmented decode step
by 6% on some seeds, where one seed read alike to 0.1%; the order alone
still moves its run-chain kernel by some 5% on some seeds.

A .quiva entry is a header line ``@<movie>/<well>/<beg>_<end> RQ=0.<qv>``
and five lines of one length each: delQV, delTag, insQV, mergeQV, subQV.
delTag is 'n' exactly where delQV is the configuration's run character (as
an instrument writes it, so the scan elects that character as delChar) and
a base letter elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEL, TAG, INS, MRG, SUB = range(5)


@dataclass
class QuivaData:
    prefix: bytes           # '@' and the movie name: the header up to its first '/'
    wells: np.ndarray       # (N,) int32, non-decreasing
    begs: np.ndarray        # (N,) int32
    ends: np.ndarray        # (N,) int32
    qvs: np.ndarray         # (N,) int32
    lengths: np.ndarray     # (N,) int64
    streams: np.ndarray     # (5, total) uint8: del, tag, ins, mrg, sub

    @property
    def bases(self) -> int:
        return int(self.lengths.sum())

    @property
    def payload_bytes(self) -> int:
        """The five channels' symbols: what a .quiva holds beside its
        headers and newlines."""
        return 5 * self.bases


def read_lengths(cfg: dict) -> np.ndarray:
    """The file's read lengths, the same for every seed.

    ``lognormal``: the JAX package's ``bench.py::lognormal_lengths`` mix
    (median ``median``, sigma ``sigma``, clamped to [min, max]) drawn one
    read at a time until the reads hold the configuration's
    ``bases_per_file``; ``uniform``: ``reads_per_file`` lengths uniform in
    [min, max]."""
    spec = cfg["lengths"]
    rng = np.random.default_rng(int(spec["seed"]))
    if spec["dist"] == "lognormal":
        lens, tot = [], 0
        while tot < int(cfg["bases_per_file"]) or not lens:
            L = int(np.clip(rng.lognormal(np.log(spec["median"]), spec["sigma"]),
                            spec["min"], spec["max"]))
            lens.append(L)
            tot += L
        return np.array(lens, np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(spec["min"], spec["max"] + 1,
                            size=int(cfg["reads_per_file"])).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _seed_words(seed: int, index: int) -> list[int]:
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(index)]


def _geometric(rng, spec: dict, n: int) -> np.ndarray:
    """``n`` values ``first`` .. ``first + count - 1`` with weights
    ``ratio ** k``: a skewed QV distribution."""
    k = int(spec["count"])
    w = float(spec["ratio"]) ** np.arange(k)
    cdf = np.cumsum(w) / w.sum()
    idx = np.minimum(np.searchsorted(cdf, rng.random(n), side="right"), k - 1)
    return (int(spec["first"]) + idx).astype(np.uint8)


def _run_channel(rng, spec: dict, n: int) -> np.ndarray:
    out = np.full(n, int(spec["run_char"]), np.uint8)
    lit = rng.random(n) >= float(spec["run_share"])
    out[lit] = _geometric(rng, spec["literals"], int(lit.sum()))
    return out


def make_file(cfg: dict, seed: int, index: int) -> QuivaData:
    """File ``index`` of a run with ``seed``: the configuration's reads of
    that file, in an order drawn from the seed, and every header field
    drawn from the seed."""
    fixed = np.random.default_rng([int(cfg["lengths"]["seed"]), int(index), 5039])
    lens = read_lengths(cfg)
    n = len(lens)
    reads = _streams(fixed, cfg["channels"], int(lens.sum()))
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])

    rng = np.random.default_rng(_seed_words(seed, index))
    order = rng.permutation(n)
    lengths = lens[order]
    streams = reads[:, _ragged_positions(starts[order], lengths)]
    wells = np.cumsum(rng.integers(0, 3, size=n)).astype(np.int32)
    begs = rng.integers(0, 50, size=n).astype(np.int32)
    ends = (begs + lengths).astype(np.int32)
    qvs = rng.integers(0, 1000, size=n).astype(np.int32)
    return QuivaData(b"@" + cfg["movie"].encode(), wells, begs, ends, qvs,
                     lengths.astype(np.int64), streams)


def _streams(rng, ch: dict, total: int) -> np.ndarray:
    """(5, total) symbols of the five channels, drawn from ``rng``: delTag
    'n' exactly where delQV is its run character, a base letter elsewhere."""
    streams = np.empty((5, total), np.uint8)
    streams[DEL] = _run_channel(rng, ch["del"], total)
    letters = np.frombuffer(b"acgt", np.uint8)
    streams[TAG] = letters[rng.integers(0, 4, size=total)]
    streams[TAG][streams[DEL] == int(ch["del"]["run_char"])] = ord("n")
    streams[INS] = _geometric(rng, ch["ins"], total)
    streams[MRG] = _geometric(rng, ch["mrg"], total)
    streams[SUB] = _run_channel(rng, ch["sub"], total)
    return streams


def quiva_text(q: QuivaData) -> bytes:
    """The .quiva image: per entry its header line and five stream lines."""
    n = len(q.lengths)
    headers = [q.prefix + f"/{w}/{b}_{e} RQ=0.{v}".encode()
               for w, b, e, v in zip(q.wells.tolist(), q.begs.tolist(),
                                     q.ends.tolist(), q.qvs.tolist())]
    hdr_lens = np.array([len(h) for h in headers], np.int64)
    lengths = q.lengths.astype(np.int64)
    blk = hdr_lens + 1 + 5 * (lengths + 1)
    boff = np.zeros(n + 1, np.int64)
    np.cumsum(blk, out=boff[1:])
    out = np.full(int(boff[-1]), ord("\n"), np.uint8)
    out[_ragged_positions(boff[:-1], hdr_lens)] = np.frombuffer(b"".join(headers), np.uint8)
    base = boff[:-1] + hdr_lens + 1
    for s in range(5):
        out[_ragged_positions(base + s * (lengths + 1), lengths)] = q.streams[s]
    return out.tobytes()


def _ragged_positions(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Every position starts[i] + j, j < lens[i], in order."""
    total = int(lens.sum())
    first = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=first[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(first - starts, lens)
