"""Synthetic inputs for tests and ``chip_smoke.py``, without JAX.

``make_quiva`` is a copy of ``tests/conftest.py::make_quiva`` (which cannot
be imported where JAX is absent: that conftest imports it) and gives the
same bytes for the same generator state.  ``lognormal_lengths`` is
``bench.py::lognormal_lengths``.  ``step_batch`` builds the arguments of
``qv_encode_step`` for a .quiva image the way ``bench.py`` and
``__graft_entry__._example_batch`` do.
"""

from __future__ import annotations

import numpy as np

BENCH_MB = 16               # bench.py's batch size: prep_data(16)
UNIFORM_READ_LEN = 2000     # bench.py READ_LEN


def make_quiva(rng, n_reads=12, min_len=0, max_len=400, movie=b"m130205_1210_42",
               del_run=True, sub_heavy=False, spread=30, lengths=None):
    """A synthetic .quiva image: header + 5 equal-length QV/tag streams.

    delTag contains 'n' exactly where delQV equals one designated char so
    the delChar discovery in the scan matches real instrument output.
    ``lengths`` overrides the uniform [min_len, max_len] draw with explicit
    per-read lengths (e.g. a log-normal PacBio mix).
    """
    del_char = ord("f")
    lines = []
    well = 0
    if lengths is not None:
        n_reads = len(lengths)
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        rlen = (int(lengths[i]) if lengths is not None
                else int(rng.integers(min_len, max_len + 1)))
        beg = int(rng.integers(0, 50))
        end = beg + rlen
        qv = int(rng.integers(0, 1000))
        lines.append(f"@{movie.decode()}/{well}/{beg}_{end} RQ=0.{qv}".encode())
        if del_run:
            # runs of del_char broken by other chars
            delqv = np.full(rlen, del_char, np.uint8)
            breaks = rng.random(rlen) < 0.25
            delqv[breaks] = rng.integers(ord("!"), ord("!") + spread, size=int(breaks.sum()))
        else:
            delqv = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        tag = rng.choice(np.frombuffer(b"acgt", np.uint8), size=rlen)
        tag[delqv == del_char] = ord("n")
        ins = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        mrg = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        if sub_heavy:
            sub = np.full(rlen, ord("k"), np.uint8)
            breaks = rng.random(rlen) < 0.2
            sub[breaks] = rng.integers(ord("!"), ord("!") + spread, size=int(breaks.sum()))
        else:
            sub = rng.integers(ord("!"), ord("!") + spread, size=rlen).astype(np.uint8)
        for stream in (delqv, tag, ins, mrg, sub):
            lines.append(stream.tobytes())
    return b"\n".join(lines) + b"\n"


def lognormal_lengths(mb: int = BENCH_MB) -> np.ndarray:
    """PacBio subread mix: log-normal, ~10 kb median, clamped to
    1,500-60,000, drawn until the five-channel payload reaches ~2x the
    ``mb`` uniform batch."""
    rng = np.random.default_rng(1)
    target = 2 * mb * 1_000_000 / 5
    lens, tot = [], 0
    while tot < target:
        L = int(np.clip(rng.lognormal(np.log(10_000), 0.8), 1_500, 60_000))
        lens.append(L)
        tot += L
    return np.array(lens, np.int64)


def uniform_quiva() -> bytes:
    """The uniform batch of ``bench.py::prep_data(16)``: 1,600 reads of
    1,950-2,050 symbols, seed 0."""
    n_reads = max(8, (BENCH_MB * 1_000_000) // (5 * UNIFORM_READ_LEN))
    return make_quiva(np.random.default_rng(0), n_reads=n_reads,
                      min_len=UNIFORM_READ_LEN - 50, max_len=UNIFORM_READ_LEN + 50)


def long_quiva() -> bytes:
    """The log-normal long-read batch of ``bench.py::prep_data(16)``,
    seed 2."""
    return make_quiva(np.random.default_rng(2), lengths=lognormal_lengths())


def step_batch(quiva: bytes):
    """(qv_encode_step arguments, run_on) for a whole .quiva image as one
    rectangle: rows padded by ``pad_rows(align=512, bucket=True)`` and the
    row count by ``bucket_rows``, as ``bench.py`` builds its headline step."""
    from dextractor_tpu.formats.quiva import parse_quiva
    from dextractor_tpu.formats.ragged import bucket_rows, pad_rows

    from .codecs.qv_codec import create_qvcoding, scan_quiva, step_tables

    q = parse_quiva(quiva)
    lengths = q.lengths.astype(np.int64)
    streams = np.stack([pad_rows(q.streams[s], lengths, align=512, bucket=True)
                        for s in range(5)])
    n = q.n_entries
    n_pad = bucket_rows(n)
    if n_pad != n:
        streams = np.concatenate(
            [streams, np.zeros((5, n_pad - n, streams.shape[2]), np.uint8)], 1)
        lengths = np.concatenate([lengths, np.zeros(n_pad - n, np.int64)])
    coding = create_qvcoding(scan_quiva(q), q.prefix, False)
    sym, run, rchars, nlut, run_on = step_tables(coding)
    return (streams, lengths.astype(np.int32), sym, run, rchars, nlut.copy()), run_on
