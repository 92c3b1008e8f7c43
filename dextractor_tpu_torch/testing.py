"""Synthetic inputs for tests and ``chip_smoke.py``, without JAX.

``make_quiva``, ``make_fasta`` and ``make_arrow`` are copies of
``tests/conftest.py``'s (which cannot be imported where JAX is absent: that
conftest imports it) and give the same bytes for the same generator state;
``make_fasta`` also takes explicit read lengths.  ``make_bam`` is a copy of
the same conftest's PacBio subreads BAM writer that also takes explicit read
lengths, so ``chip_smoke.py`` builds its DB corpora as BAMs.  ``uniform_fasta``,
``long_fasta`` and ``uniform_arrow`` are the 2-bit codecs' corpora of
``chip_smoke.py``.  ``lognormal_lengths`` is
``bench.py::lognormal_lengths``.  ``step_batch`` builds the arguments of
``qv_encode_step`` for a .quiva image the way ``bench.py`` and
``__graft_entry__._example_batch`` do, ``widest_bucket_batch`` those of
the widest bucket of the device encode, ``decode_batch`` those of
``ops.decode2.decode_entry_batch2`` for a .dexqv image the way
``bench.py::_qv_dec_setup`` does; ``plain_rows`` takes K1's inputs from an
encode batch and ``run_rows`` K2's, ``widest_fused_bucket`` finds the
widest bucket K1 and K2 take.
``encode_edge_rows`` and ``run_edge_rows`` build edge rows of the encode
kernels, ``decode_edge_cases`` edge rows of the decode kernels with the
port's own encode twins, ``tag_edge_cases`` edge inputs of K10.

No weights or parameters are carried over from the JAX package: the
``.dexqv`` tables are built from each file's data (tests convert the JAX
package's with ``formats.dexqv.coding_from_reference``), and the 2-bit
tables are constants copied byte for byte into ``ops/twobit.py``, each held
to its original by ``tests/test_torch_twobit_kernels.py``.
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


def make_fasta(rng, n_reads=20, min_len=0, max_len=700, movie=b"m130205_1210_42", width=80,
               with_rq=True, well_jumps=False, lengths=None):
    """A synthetic PacBio-style .fasta image.  ``lengths`` overrides the
    uniform [min_len, max_len] draw with explicit per-read lengths."""
    lines = []
    well = 0
    if lengths is not None:
        n_reads = len(lengths)
    for i in range(n_reads):
        well += int(rng.integers(0, 600 if well_jumps else 3))
        rlen = (int(lengths[i]) if lengths is not None
                else int(rng.integers(min_len, max_len + 1)))
        beg = int(rng.integers(0, 100))
        end = beg + rlen
        qv = int(rng.integers(0, 1000))
        hdr = f">{movie.decode()}/{well}/{beg}_{end}"
        if with_rq:
            hdr += f" RQ=0.{qv}"
        lines.append(hdr.encode())
        seq = rng.choice(np.frombuffer(b"acgt", np.uint8), size=rlen)
        for j in range(0, rlen, width):
            lines.append(seq[j:j + width].tobytes())
    return b"\n".join(lines) + b"\n"


def make_arrow(rng, n_reads=20, min_len=0, max_len=700, movie=b"m130205_1210_42", width=80):
    """A synthetic PacBio-style .arrow image."""
    lines = []
    well = 0
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        rlen = int(rng.integers(min_len, max_len + 1))
        beg = int(rng.integers(0, 100))
        end = beg + rlen
        snr = rng.uniform(0.5, 120.0, size=4)
        hdr = (f">{movie.decode()}/{well}/{beg}_{end} "
               f"SN={snr[0]:.2f},{snr[1]:.2f},{snr[2]:.2f},{snr[3]:.2f}")
        lines.append(hdr.encode())
        seq = rng.choice(np.frombuffer(b"1234", np.uint8), size=rlen)
        for j in range(0, rlen, width):
            lines.append(seq[j:j + width].tobytes())
    return b"\n".join(lines) + b"\n"


_BAM_SEQ_CODE = np.zeros(256, np.uint8)          # base -> BAM 4-bit code
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BAM_SEQ_CODE[_c] = _i


def make_bam(rng, n_reads=8, min_len=50, max_len=300, movie=b"m54238_180903_1",
             with_qv=True, with_pw=True, gz=True, lengths=None, level=9):
    """A minimal PacBio subreads BAM image (+ the expected per-record
    fields): a copy of ``tests/conftest.py::make_bam`` that gives the same
    bytes for the same generator state.  ``lengths`` overrides the uniform
    [min_len, max_len] draw with explicit per-read lengths; ``level`` is
    the gzip level of the image (9, as the copy's original)."""
    import gzip
    import struct

    if lengths is not None:
        n_reads = len(lengths)
    recs = []
    body = []
    well = 0
    for i in range(n_reads):
        well += int(rng.integers(0, 3))
        ln = (int(lengths[i]) if lengths is not None
              else int(rng.integers(min_len, max_len + 1)))
        beg = int(rng.integers(0, 100))
        end = beg + ln
        qname = b"%s/%d/%d_%d" % (movie, well, beg, end)
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln).tobytes()
        rq = float(np.float32(rng.uniform(0.6, 1.0)))
        snr = rng.uniform(3, 12, 4).astype(np.float32)
        pw = rng.integers(1, 7, ln).astype(np.uint8)
        # dq/iq/mq/sq are FASTQ-encoded QVs; dt is a base tag (acgt + 'n')
        dq = (rng.integers(33, 80, ln)).astype(np.uint8)
        dt = rng.choice(np.frombuffer(b"acgt", np.uint8), size=ln)
        dt[dq == 70] = ord("n")
        qvs = [dq.tobytes(), dt.tobytes(),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8)),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8)),
               bytes((rng.integers(33, 80, ln)).astype(np.uint8))]
        tags = [b"qs" + b"i" + struct.pack("<i", beg),
                b"qe" + b"i" + struct.pack("<i", end),
                b"rq" + b"f" + struct.pack("<f", rq),
                b"np" + b"i" + struct.pack("<i", int(rng.integers(1, 20))),
                b"sn" + b"B" + b"f" + struct.pack("<i", 4) + snr.astype("<f4").tobytes()]
        if with_pw:
            tags.append(b"pw" + b"B" + b"C" + struct.pack("<i", ln) + pw.tobytes())
        if with_qv:
            tags += [t + b"Z" + v + b"\x00"
                     for t, v in zip((b"dq", b"dt", b"iq", b"mq", b"sq"), qvs)]

        idx = _BAM_SEQ_CODE[np.frombuffer(seq, np.uint8)]
        packed = np.zeros((ln + 1) // 2, np.uint8)
        packed[: (ln // 2)] = (idx[0:ln - 1:2] << 4) | idx[1:ln:2]
        if ln % 2:
            packed[-1] = idx[-1] << 4
        rec = b"".join([struct.pack("<iiBBHHHiii", -1, -1, len(qname) + 1, 255, 0, 0,
                                    4, ln, -1, -1),
                        struct.pack("<i", 0), qname + b"\x00", packed.tobytes(),
                        b"\xff" * ln, *tags])
        body += [struct.pack("<i", len(rec)), rec]
        recs.append(dict(qname=qname, well=well, beg=beg, end=end, ln=ln,
                         seq=seq, rq=rq, snr=snr, pw=pw, qvs=qvs))

    header_text = b"@HD\tVN:1.5\tSO:unknown\n"
    bam = b"".join([b"BAM\x01", struct.pack("<i", len(header_text)), header_text,
                    struct.pack("<i", 0), *body])
    if gz:
        bam = gzip.compress(bam, compresslevel=level)
    return bam, recs


def uniform_fasta(n_reads: int = 32_000) -> bytes:
    """32,000 reads of 1,950-2,050 bases, seed 0: ~64 M bases, ~66 MB of text."""
    return make_fasta(np.random.default_rng(0), n_reads=n_reads,
                      min_len=UNIFORM_READ_LEN - 50, max_len=UNIFORM_READ_LEN + 50)


def long_fasta(mb: int = 64) -> bytes:
    """Long reads of ``lognormal_lengths(mb)`` (1,500-60,000 bases), seed 2."""
    return make_fasta(np.random.default_rng(2), lengths=lognormal_lengths(mb))


def uniform_arrow(n_reads: int = 8_000) -> bytes:
    """8,000 reads of 1,950-2,050 pulse-width symbols, seed 0."""
    return make_arrow(np.random.default_rng(0), n_reads=n_reads,
                      min_len=UNIFORM_READ_LEN - 50, max_len=UNIFORM_READ_LEN + 50)


def lognormal_lengths(mb: int = BENCH_MB) -> np.ndarray:
    """PacBio subread mix: log-normal, ~10 kb median, clamped to
    1,500-60,000, drawn until the five-channel payload reaches ~2x the
    ``mb`` uniform batch (one read at least)."""
    rng = np.random.default_rng(1)
    target = 2 * mb * 1_000_000 / 5
    lens, tot = [], 0
    while tot < target or not lens:
        L = int(np.clip(rng.lognormal(np.log(10_000), 0.8), 1_500, 60_000))
        lens.append(L)
        tot += L
    return np.array(lens, np.int64)


def uniform_quiva(mb: int = BENCH_MB) -> bytes:
    """The uniform batch of ``bench.py::prep_data(mb)``: at the default 16
    MB, 1,600 reads of 1,950-2,050 symbols, seed 0 (8 reads at least)."""
    n_reads = max(8, (mb * 1_000_000) // (5 * UNIFORM_READ_LEN))
    return make_quiva(np.random.default_rng(0), n_reads=n_reads,
                      min_len=UNIFORM_READ_LEN - 50, max_len=UNIFORM_READ_LEN + 50)


def long_quiva(mb: int = BENCH_MB) -> bytes:
    """The log-normal long-read batch of ``bench.py::prep_data(mb)``, seed 2
    (one read at least)."""
    return make_quiva(np.random.default_rng(2), lengths=lognormal_lengths(mb))


def step_batch(quiva: bytes):
    """(qv_encode_step arguments, run_on) for a whole .quiva image as one
    rectangle: rows padded by ``pad_rows(align=512, bucket=True)`` and the
    row count by ``bucket_rows``, as ``bench.py`` builds its headline step."""
    from .codecs.qv_codec import create_qvcoding, scan_quiva, step_tables
    from .formats.quiva import parse_quiva
    from .formats.ragged import bucket_rows, pad_rows

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


def widest_bucket_batch(quiva: bytes, index: int = -1):
    """(qv_encode_step arguments, run_on) of the widest bucket (or the
    ``index``-th in order of width) of the device encode of a .quiva image,
    built as ``codecs.qv_codec`` builds it (``encode_buckets``,
    ``bucket_rect``), with the whole file's coding."""
    from .codecs.qv_codec import (bucket_rect, create_qvcoding, encode_buckets,
                                  scan_quiva, step_tables)
    from .formats.quiva import parse_quiva

    q = parse_quiva(quiva)
    coding = create_qvcoding(scan_quiva(q), q.prefix, False)
    sym, run, rchars, nlut, run_on = step_tables(coding)
    width, sel = encode_buckets(q.lengths)[index]
    rect, lengths = bucket_rect(q, sel, width, False)
    return (rect, lengths, sym, run, rchars, nlut.copy()), run_on


def widest_fused_bucket(quiva: bytes):
    """(index, width) of the widest bucket of the device encode of a .quiva
    image that the encode step sends through K1/K2 (``emit.fused_ok``)."""
    from .codecs.qv_codec import encode_buckets
    from .formats.quiva import parse_quiva
    from .ops.emit import fused_ok

    widths = [w for w, _ in encode_buckets(parse_quiva(quiva).lengths)]
    i = max(i for i, w in enumerate(widths) if fused_ok(w))
    return i, widths[i]


def plain_rows(batch):
    """K1's arguments for the plain QV channels of an encode-step batch
    ((arguments, run_on) of ``step_batch`` or ``widest_bucket_batch``):
    (data (C, N, L) u8, lengths (N,) i32, LUTs (C, 256) i32), NumPy."""
    (streams, lengths, sym, _, _, _), run_on = batch
    run_cs = [c for c, on in ((0, run_on[0]), (3, run_on[1])) if on]
    plain_cs = [c for c in range(4) if c not in run_cs]
    plane = (0, 2, 3, 4)
    return (np.ascontiguousarray(streams[[plane[c] for c in plain_cs]]), lengths,
            np.ascontiguousarray(sym[plain_cs]))


def run_rows(batch):
    """K2's arguments for the RLE QV channels of an encode-step batch (as
    ``plain_rows``): (data (C, N, L) u8, lengths (N,) i32, symbol LUTs (C,
    256) i32, run LUTs (C, 256) i32, rchars (C,) i32), NumPy; C is 0 when
    the batch has no RLE channel."""
    (streams, lengths, sym, run, rchars, _), run_on = batch
    run_cs = [c for c, on in ((0, run_on[0]), (3, run_on[1])) if on]
    plane = (0, 2, 3, 4)
    return (np.ascontiguousarray(streams[[plane[c] for c in run_cs]]), lengths,
            np.ascontiguousarray(sym[run_cs]), np.ascontiguousarray(run[run_cs]),
            np.ascontiguousarray(rchars[run_cs]))


def decode_batch(dexqv: bytes):
    """(positional arguments, keyword arguments) of ``decode_entry_batch2``
    for every entry of a .dexqv image as one rectangle: rows padded to
    ``bucket_rows``, as ``bench.py::_qv_dec_setup`` builds its decode step.
    The arrays are numpy (rects as int32 bit patterns); del_char/sub_char
    are ints."""
    from .codecs.qv_batch import channel_rects, decode_tables_v2
    from .codecs.qv_codec import _index_native
    from .formats import dexqv as dq
    from .formats.ragged import bucket_len, bucket_rows

    coding, off = dq.parse_qvcoding(memoryview(dexqv), 2)
    _, _, _, _, eoffs, elens, coffs, ntoks = _index_native(dexqv, coding, off, True)
    n = len(eoffs)
    n_pad = bucket_rows(n)
    rlens = np.pad(elens.astype(np.int32), (0, n_pad - n))
    max_len = bucket_len(int(rlens.max(initial=0)), 512)
    max_tokens = bucket_len(int(ntoks.max(initial=0)), 16)
    rects = channel_rects(np.frombuffer(dexqv, np.uint8), eoffs, coffs, max_len)
    rects = [np.concatenate([r, np.zeros((n_pad - n, r.shape[1]), r.dtype)])
             for r in rects]
    rects = [r.view(np.int32) if r.dtype == np.uint32 else r for r in rects]
    sids, f1, f2, types, del_mode, sub_mode, subw, lmax = decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    args = (*rects, rlens, sids, f1, f2, types, coding.del_char & 0xFF,
            coding.sub_char & 0xFF)
    return args, dict(max_len=max_len, max_tokens=max_tokens, del_mode=del_mode,
                      sub_mode=sub_mode, subw=subw, lmax=lmax, chan_l2=chan_l2)


def batch_to(args, device):
    """``decode_batch`` arguments with the rects, rlens and tables as
    tensors on ``device`` (sids and types stay host arrays)."""
    import torch

    return tuple(torch.from_numpy(a).to(device) if i in (0, 1, 2, 3, 4, 5, 7, 8)
                 else a for i, a in enumerate(args))


def edge_schemes() -> dict:
    """Schemes for the decode edge cases: codes of at most 8, 12 and 16
    bits, a truncated type-2 scheme whose rare symbols escape, a
    single-symbol scheme (0-bit codes), a run scheme whose runs over 3
    take long codes and 255 and over the 16-bit escape, and a symbol and a
    run scheme whose every code is 8 bits long (flat histograms).  name ->
    (scheme, alphabet size)."""
    from .ops.huffman import make_scheme

    rng = np.random.default_rng(5)
    h = {k: np.zeros(256, np.int64) for k in
         ("lmax8", "lmax12", "lmax16", "type2", "zero_bit", "run", "flat8",
          "run_flat8")}
    h["lmax8"][:30] = 50
    h["lmax12"][:44] = rng.integers(1, 100, 44)
    h["lmax16"][:] = rng.integers(1, 100, 256)
    h["type2"][:] = 1
    h["type2"][:40] += (1.6 ** np.arange(40)).astype(np.int64)
    h["zero_bit"][0] = 1000
    h["run"][:] = 1
    h["run"][:4] = 50_000
    h["flat8"][:] = 7
    h["run_flat8"][:] = 7
    sizes = {"lmax8": 30, "lmax12": 44, "lmax16": 256, "type2": 256,
             "zero_bit": 1, "run": 256, "flat8": 256, "run_flat8": 256}
    return {k: (make_scheme(v), sizes[k]) for k, v in h.items()}


def decode_edge_cases(device, long_len: int = 70_000, row_len: int = 2500):
    """Edge cases of the decode kernels on ``device``, encoded by the port's
    encode twins (ops/bitstream_torch), so each decode has an exact answer:
    (name, wrapper name, args, kwargs, expect).  The wrapper is
    ``decode_plain`` or ``decode_run`` of ops/decode_chains; ``expect``
    holds the symbols each chain must decode ("syms", zero-padded, or for
    run chains the expanded rows with "rchar"), and the encoder's "t" and
    "lg", which the chain's ``bits`` and ``last`` must equal.

    The cases: four plain channels with different schemes and rectangle
    widths in one launch (type-2 escapes, codes up to 12 and 16 bits with
    the L2 table, 0-bit codes); one channel with lmax 12 tables and a
    ``long_len``-symbol row; plain chains resumed at ``pos0``; run chains
    with runs over 255 (the 16-bit escape) and up to 65,535, type-2
    literal escapes, and chains resumed at ``pos0`` inside a run
    (``carry``); run chains whose every code is 8 bits long (no
    resynchronisation: a decoder that starts on a code boundary in the
    wrong phase never meets the true path) and run chains whose every run
    and literal is an escape.  Rows of 0 and 1 symbols throughout.  The
    plain rows, the type-2 and the 8-bit run rows are up to ``row_len``
    symbols wide.  Together the
    cases hold L2 tables of more and of fewer entries than
    ``ops.decode_chains.SMEM_L2_MAX``.  After the first three plain cases
    come plain chains whose every code is 8 bits long (also resumed at
    ``pos0``), whose every symbol is an escape (rows of ``row_len + 1``,
    no multiple of 4), and a ``long_len``-symbol row of 0-bit codes."""
    import torch

    from .ops import bitstream_torch as bt
    from .ops import decode2 as d2

    sch = edge_schemes()
    rng = np.random.default_rng(23)
    dev = torch.device(device)
    cases = []

    def tensor(x, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dtype)

    def tables(names):
        f1, f2, subw, lmax = d2.scheme_tables2([sch[k][0] for k in names])
        subws = [subw if ((f1[i] >> 20) & 1).any() else 0 for i in range(len(names))]
        return tensor(f1), tensor(f2), subws, lmax

    def signal(name):
        return 255 if sch[name][0].type == 2 else 256

    def plain_case(name, names, data, lengths, starts=None):
        """data (C, N, L); chains decode lengths - starts symbols from bit
        t(data[:starts])."""
        c, n, l = data.shape
        luts = tensor(np.stack([bt.scheme_luts(sch[k][0]) for k in names]))
        dd, ln = tensor(data, torch.uint8), tensor(lengths)
        words, t, lg = bt.encode_plain_ref(dd, ln, luts)
        starts = np.zeros(n, np.int64) if starts is None else starts
        rl = (lengths - starts).astype(np.int32)
        pos0 = None
        if starts.any():
            pos0 = bt.encode_plain_ref(dd, tensor(starts), luts)[1]
        rects = []
        for k in range(c):      # a different rectangle width per channel
            kw = int(((t[k].long() + 31) >> 5).max()) + 1 + k
            rects.append(words[k][:, :kw].contiguous())
        f1, f2, subws, lmax = tables(names)
        syms = np.zeros((c, n, l), np.uint8)
        for r in range(n):
            syms[:, r, :rl[r]] = data[:, r, starts[r]:lengths[r]]
        lg = torch.where(tensor(rl)[None] > 0, lg, 0)
        cases.append((name, "decode_plain",
                      (rects, tensor(rl), f1, f2, [signal(k) for k in names], subws),
                      dict(max_len=l, lmax=lmax, pos0=pos0),
                      dict(syms=syms, t=t, lg=lg)))

    def draw(name, n, l, gen=rng):
        return gen.integers(0, sch[name][1], (n, l)).astype(np.uint8)

    # four plain channels, one launch
    names = ["type2", "lmax12", "lmax16", "zero_bit"]
    w = row_len
    lengths = np.array([w, 0, 1, w - 1, w // 2 - 16, w, 7, w * 4 // 5 - 1])
    data = np.stack([draw(k, len(lengths), w) for k in names])
    plain_case("plain C=4: type-2 escapes, lmax 12/16 (L2), 0-bit codes",
               names, data, lengths)
    # one channel, lmax 12 tables (subw 16), a long row
    lengths = np.array([long_len, 1, 0, min(5000, long_len)])
    plain_case(f"plain C=1: lmax 12 tables, a {long_len}-symbol row", ["lmax12"],
               draw("lmax12", 4, long_len)[None], lengths)
    # plain chains resumed at pos0
    names = ["type2", "lmax8"]
    lengths = np.array([w, w * 4 // 5, 1, w - 100, w * 9 // 25])
    starts = np.array([w // 2 - 16, 0, 0, w - 101, 17])
    plain_case("plain C=2: resumed at pos0", names,
               np.stack([draw(k, len(lengths), w) for k in names]), lengths, starts)
    # every code 8 bits long (a lane that starts inside a code never meets
    # the true boundaries), also resumed at pos0; these plain cases draw from
    # a generator of their own, so the run cases below keep their data
    gen = np.random.default_rng(31)
    lengths = np.array([w, w - 3, 1, 0, w * 3 // 5])
    starts = np.array([w // 2, 0, 0, 0, 11])
    plain_case("plain: fixed 8-bit codes, resumed at pos0", ["flat8"],
               draw("flat8", len(lengths), w, gen)[None], lengths, starts)
    # every symbol an escape (a rare symbol of the type-2 scheme: code + 8
    # bits), in rows whose width is no multiple of 4
    lengths = np.array([w + 1, w, 1, 0, 33])
    rare = gen.integers(40, 256, (1, len(lengths), w + 1)).astype(np.uint8)
    plain_case("plain: every symbol an escape", ["type2"], rare, lengths)
    # 0-bit codes only (a single-symbol scheme) in a long row
    lengths = np.array([long_len, 0, 1, 33])
    plain_case(f"plain: 0-bit codes, a {long_len}-symbol row", ["zero_bit"],
               np.zeros((1, len(lengths), long_len), np.uint8), lengths)

    rchar = ord("f")

    def run_rows(n, l, dense):
        d = np.full((n, l), rchar, np.uint8)
        lit = rng.random((n, l)) < dense
        d[lit] = rng.integers(0, 256, int(lit.sum()))
        d[d == rchar] = rchar
        return d

    def run_case(name, sym, data, lengths, starts=None, carry=None, run="run"):
        n, l = data.shape
        sl = tensor(bt.scheme_luts(sch[sym][0])[None])
        rlut = tensor(bt.scheme_luts(sch[run][0], run=True)[None])
        rc = tensor([rchar])
        dd, ln = tensor(data[None], torch.uint8), tensor(lengths)
        words, t, lg = bt.encode_run_ref(dd, ln, sl, rlut, rc)
        starts = np.zeros(n, np.int64) if starts is None else starts
        rl = (lengths - starts).astype(np.int32)
        pos0 = None
        if starts.any():
            cut = starts if carry is None else starts + np.maximum(carry, 0)
            pos0 = bt.encode_run_ref(dd, tensor(cut), sl, rlut, rc)[1][0]
        kw = int(((t[0].long() + 31) >> 5).max()) + 1
        f1, f2, subws, lmax = tables([run, sym])
        rows = np.full((n, l), rchar, np.uint8)
        for r in range(n):
            rows[r, :rl[r]] = data[r, starts[r]:lengths[r]]
        lits = (data != rchar) & (np.arange(l) < lengths[:, None])
        max_tokens = int(lits.sum(1).max()) + 1
        lg0 = torch.where(tensor(rl) > 0, lg[0], 0)
        cases.append((name, "decode_run",
                      (words[0][:, :kw].contiguous(), tensor(rl), f1[0], f1[1], f2,
                       signal(sym)),
                      dict(max_tokens=max_tokens, subw=max(subws), lmax=lmax, pos0=pos0,
                           carry=None if carry is None else tensor(carry)),
                      dict(rows=rows, rchar=rchar, rlens=rl, t=t[0], lg=lg0)))

    # runs over 255 and up to 65,535; rows of 0 and 1 symbols
    l = max(long_len, 6000)
    data = run_rows(8, l, 0.2)
    lengths = np.array([6000, 5000, 3000, 0, 1, 1, long_len, min(65_546, l)])
    data[0] = rchar
    data[0, ::300] = 40                    # runs of 299
    data[1] = rchar                        # one trailing run of 5,000
    data[4, 0] = 7
    data[5, 0] = rchar
    data[6] = rchar
    data[6, :long_len // 7:1000] = 9       # then one long trailing run
    data[7] = rchar
    data[7, min(65_535, l - 11)] = 3       # a run of 65,535 before a literal
    run_case("run: runs over 255 and up to 65,535, lmax 16", "lmax16", data, lengths)

    # resumed inside a run (carry >= 0), or at a run code (carry -1)
    starts = np.zeros(8, np.int64)
    carry = np.full(8, -1, np.int64)
    for r in range(8):
        lit = np.flatnonzero(data[r, :lengths[r]] != rchar)
        prev = np.concatenate([[-1], lit[:-1]])
        gap = lit - prev - 1
        ok = np.flatnonzero(gap >= 2)
        if len(ok):                        # inside the run before literal q
            q = ok[len(ok) // 2]
            c = gap[q] // 2
            starts[r] = prev[q] + 1 + c
            carry[r] = gap[q] - c
        elif len(lit):                     # just after a literal
            starts[r] = lit[0] + 1
    run_case("run: resumed at pos0, inside a run (carry)", "lmax16", data, lengths,
             starts, carry)
    # type-2 literal escapes
    run_case("run: type-2 literal escapes", "type2", run_rows(4, w, 0.6),
             np.array([w, 1, 0, w * 18 // 25]))
    # every code 8 bits long: runs, literals and 16-bit run escapes, also
    # resumed at pos0 after a literal (byte-aligned) and inside a run
    data = run_rows(5, w, 0.5)
    data[3, ::301] = rchar                 # a few runs over 255: escapes
    data[3, w // 5: w // 5 + 2 * w // 3] = rchar
    data[3, w // 5 + 2 * w // 3] = 200
    lengths = np.array([w, w - 3, 1, w, w * 3 // 5])
    run_case("run: fixed 8-bit codes", "flat8", data, lengths, run="run_flat8")
    starts = np.array([w // 2, 0, 0, w // 5 + w // 3, 11])
    data[0, w // 2 - 1] = data[4, 10] = 200    # resumed right after a literal
    carry = np.full(5, -1, np.int64)           # row 3: inside a run
    carry[3] = int(np.flatnonzero(data[3, starts[3]:] != rchar)[0])
    run_case("run: fixed 8-bit codes, resumed at pos0", "flat8", data, lengths,
             starts, carry, run="run_flat8")
    # every run (>= 255: the 16-bit escape) and every literal (a rare
    # symbol of the type-2 scheme: code + 8 bits) an escape
    l = max(long_len // 4, 3000)
    data = np.full((3, l), rchar, np.uint8)
    for r in range(3):
        at = np.cumsum(rng.integers(256, 700, l // 256))
        at = at[at < l]
        data[r, at] = rng.choice(np.setdiff1d(np.arange(40, 256), [rchar]), len(at))
    run_case("run: every code an escape", "type2", data, np.array([l, l - 1, 300]))
    return cases


def check_decode_case(name, out, expect):
    """Raise AssertionError unless a decode wrapper's outputs ``out``
    answer ``expect`` of ``decode_edge_cases``."""
    import torch

    from .ops import decode2 as d2

    if "syms" in expect:
        syms, bits, last = out
        ok = np.array_equal(syms.cpu().numpy(), expect["syms"])
    else:
        runs, lits, bits, last = out
        rows = d2.expand_runs2(runs.cpu(), lits.cpu(), expect["rchar"],
                               max_len=expect["rows"].shape[1]).numpy()
        col = np.arange(rows.shape[1])[None, :] < expect["rlens"][:, None]
        ok = np.array_equal(np.where(col, rows, 0), np.where(col, expect["rows"], 0))
    stats = (torch.equal(bits.cpu(), expect["t"].cpu().to(torch.int32))
             and torch.equal(last.cpu(), expect["lg"].cpu().to(torch.int32)))
    if not (ok and stats):
        raise AssertionError(f"{name}: decoded symbols {'ok' if ok else 'wrong'}, "
                             f"bits/last {'ok' if stats else 'differ from the encoder'}")


def encode_edge_rows(width: int = 9000):
    """Edge inputs of K1 (ops/emit.encode_plain), NumPy: (label, data (C, N,
    L) u8, lengths (N,) i32, packed LUTs (C, 256) i32).  Rows of 0, 1, 31,
    32, 33 symbols and of every width up to ``width``, in four channels of
    one launch (type-2 escapes, codes of up to 16 bits, 0-bit codes, 8-bit
    codes); rows whose every symbol is an escape (24-bit emissions that
    straddle words) and rows of 0-bit codes only, each over ``width``
    symbols; and a row width no multiple of 16 (rows that take byte loads)."""
    from .ops import bitstream_torch as bt

    sch = edge_schemes()
    rng = np.random.default_rng(37)

    def luts(names):
        return np.stack([bt.scheme_luts(sch[k][0]) for k in names]).astype(np.int32)

    w = width
    lengths = np.array([0, 1, 31, 32, 33, w, w - 1, w // 2 + 5, 2 * w // 3], np.int32)
    names = ["type2", "lmax16", "zero_bit", "flat8"]
    data = np.stack([rng.integers(0, sch[k][1], (len(lengths), w)) for k in names])
    rare = rng.integers(40, 256, (1, len(lengths), w))
    ragged = rng.integers(0, 256, (1, len(lengths), w - 5))
    return [("rows of 0, 1, 31, 32, 33 symbols and up to the width, four schemes",
             data.astype(np.uint8), lengths, luts(names)),
            ("every symbol an escape", rare.astype(np.uint8), lengths, luts(["type2"])),
            ("0-bit codes only", np.zeros((1, len(lengths), w), np.uint8), lengths,
             luts(["zero_bit"])),
            (f"width {w - 5} (byte loads)", ragged.astype(np.uint8),
             np.minimum(lengths, w - 5).astype(np.int32), luts(["lmax16"]))]


PACK_TILE_BYTES = 4096   # payload bytes per K7 block (kPackTile in ops/csrc/twobit.cu)


def twobit_tile_edges(tile: int = PACK_TILE_BYTES, seed: int = 23):
    """Edge inputs of K7's payload tiles of ``tile`` bytes, NumPy: (label,
    flat u8 random bytes, lengths (N,) i64, lead): the reads are
    ``flat[lead:]`` end to end, so that their first base lies ``lead``
    bytes into the buffer (off 16-byte alignment where ``lead`` is no
    multiple of 16).  Reads of 0-7 bases; thousands of empty reads inside
    one tile; reads that end exactly at tile boundaries; a read longer than
    two tiles; many short reads a tile."""
    rng = np.random.default_rng(seed)
    b = 4 * tile    # the bases of a tile of 4-base bytes
    cases = [
        ("reads of 0-7 bases", np.tile(np.arange(8), 40), 0),
        ("runs of thousands of empty reads inside a tile",
         np.array([5] + [0] * 3000 + [9, 0, 0, 13] + [0] * 2000 + [4]), 0),
        ("reads that end at tile boundaries", np.array([b, 4, b - 4, 2 * b, 3]), 0),
        ("a read longer than two tiles", np.array([3, 2 * b + 777, 5, 1]), 0),
        ("many short reads a tile, the first base 5 bytes into the buffer",
         rng.integers(0, 40, 2000), 5),
        ("reads of ~2,000 bases, the first base 13 bytes into the buffer",
         rng.integers(1950, 2051, 2 * tile // 500 + 3), 13),
    ]
    return [(label, rng.integers(0, 256, lead + int(lengths.sum()), dtype=np.uint8),
             lengths.astype(np.int64), lead) for label, lengths, lead in cases]


UNPACK_TILE_LETTERS = 2048   # letters per unpack warp (kUnpackWarpTile in ops/csrc/twobit.cu)


def twobit_letter_tile_edges(tile: int = UNPACK_TILE_LETTERS, seed: int = 31):
    """Edge inputs of the unpack's warp tiles of ``tile`` letters, NumPy:
    (label, payload u8 random bytes, lengths (N,) i64 letters, lead): the
    reads' payloads, ceil(len/4) bytes each, are ``payload[lead:]`` end to
    end, so that the first lies ``lead`` bytes into the buffer.  Reads of
    0-7 letters; thousands of empty reads inside one tile; reads that end
    exactly at tile boundaries; a read longer than two tiles; reads of one
    letter, a payload byte each, so that a tile's payload is as long as its
    letters; many short reads a tile and reads of ~2,000 letters, with the
    payload 1, 13 and 15 bytes into its buffer."""
    rng = np.random.default_rng(seed)
    cases = [
        ("reads of 0-7 letters", np.tile(np.arange(8), 40), 0),
        ("runs of thousands of empty reads inside a tile",
         np.array([5] + [0] * 3000 + [9, 0, 0, 13] + [0] * 2000 + [4]), 0),
        ("reads that end at tile boundaries", np.array([tile, 4, tile - 4, 2 * tile, 3]), 0),
        ("a read longer than two tiles", np.array([3, 2 * tile + 777, 5, 1]), 0),
        ("reads of one letter (a payload byte a letter), the payload 15 bytes into the "
         "buffer", np.ones(2 * tile + 100, np.int64), 15),
        ("many short reads a tile, the payload 1 byte into the buffer",
         rng.integers(0, 40, 800), 1),
        ("reads of ~2,000 letters, the payload 13 bytes into the buffer",
         rng.integers(1950, 2051, 2 * tile // 500 + 3), 13),
    ]
    return [(label, rng.integers(0, 256, lead + int(((lengths + 3) >> 2).sum()),
                                 dtype=np.uint8), lengths.astype(np.int64), lead)
            for label, lengths, lead in cases]


EDGE_RCHAR = 102   # 'f': the run character (delChar) of run_edge_rows


def _run_lits(rng, w: int):
    """The literal layout of run_edge_rows at width ``w`` (>= 1,200):
    (literal mask (14, w), lengths (14,) i32)."""
    n = 14
    lit = np.zeros((n, w), bool)
    dense = rng.random((n, w)) < 0.7
    lengths = np.full(n, w, np.int32)
    lengths[:5] = [0, 1, 31, 32, 33]
    lit[[0, 2, 3, 4]] = dense[[0, 2, 3, 4]]
    lit[1, 0] = True
    # row 5: no literal, a trailing run of w
    lit[6, 0] = True                          # a literal only at column 0
    lengths[7] = w - 3
    lit[7, w - 4] = True                      # a literal only at len - 1
    col, run = 7, 255                         # runs of 255 and 256 in turn
    while col < w:
        lit[8, col] = True
        col, run = col + run + 1, 511 - run
    lit[9] = dense[9]                         # a run across the tile boundary at
    lit[9, 490:530] = False                   # 512, one across several
    lit[9, 600:min(w - 50, 600 + max(550, w // 3))] = False
    lit[10] = True                            # every symbol a literal
    lengths[11] = w - 1
    lit[11] = rng.random(w) < 0.3
    lit[12] = rng.random(w) < 0.01
    lengths[13] = w // 2 + 5
    lit[13] = dense[13]
    return lit, lengths


def _long_lits(rng, w: int):
    """Rows of ``w`` (>= 66,000) symbols with runs of 65,535 and 65,536,
    trailing runs of w - 1 and w, and a run of most of the row before dense
    literals: (literal mask (6, w), lengths (6,) i32)."""
    lit = np.zeros((6, w), bool)
    lit[0, [0, 65_536]] = True
    lit[1, [0, 65_537]] = True
    lit[2, 0] = True
    # row 3: no literal
    lit[4, 3] = True
    lit[4, w - 1000:] = rng.random(1000) < 0.7
    lit[5] = rng.random(w) < 0.7
    return lit, np.full(6, w, np.int32)


def run_edge_rows(width: int = 9000, long_len: int = 0):
    """Edge inputs of K2 (ops/emit.encode_run) and K3 (ops/emit.pack_tags),
    NumPy: (label, data (C, N, L) u8, lengths (N,) i32, symbol LUTs (C, 256)
    i32, run LUTs (C, 256) i32, rchars (C,) i32, tags (N, L) u8).  K3 takes
    the tags with data[0] as the delQV rows and rchars[0] (or -1) as
    delChar.

    Rows of 0, 1, 31, 32 and 33 symbols; a row with no literal (no tag
    kept); a literal only at column 0 and one only at len - 1; runs of 255
    and 256 in turn; a run across the tile boundary at column 512 and one
    across several (every tile a multiple of 512, or of 64 and 256 in the
    NumPy models); a row of literals only (every tag kept); dense, sparse
    and half-length rows.  Four channels of one launch, each a symbol
    scheme with a run scheme: type-2 escapes with escaped runs from 255 on,
    codes of up to 16 bits with 8-bit run codes, 0-bit literal codes, and
    8-bit codes with 16-bit run literals after 0-bit codes.  Those rows at
    ``width`` (>= 1,200) and at ``width - 5``, a width no multiple of 4
    (rows that take byte loads and byte stores); with ``long_len`` (>=
    66,000), rows of that many symbols too: runs of 65,535 and 65,536 and
    trailing runs over 65,535 (escaped as run & 0xFFFF)."""
    from .ops import bitstream_torch as bt

    sch = edge_schemes()
    rng = np.random.default_rng(41)
    pairs = [("type2", "run"), ("lmax16", "run_flat8"), ("zero_bit", "run"),
             ("flat8", "zero_bit")]
    sym = np.stack([bt.scheme_luts(sch[a][0]) for a, _ in pairs]).astype(np.int32)
    run = np.stack([bt.scheme_luts(sch[b][0], run=True) for _, b in pairs]).astype(np.int32)
    rchars = np.full(len(pairs), EDGE_RCHAR, np.int32)

    def case(label, lit, lengths):
        n, w = lit.shape
        vals = np.stack([rng.integers(0, sch[a][1], (n, w)) for a, _ in pairs])
        vals[vals == EDGE_RCHAR] = EDGE_RCHAR + 1
        data = np.where(lit[None], vals, EDGE_RCHAR).astype(np.uint8)
        tags = rng.choice(np.frombuffer(b"acgtn", np.uint8), size=(n, w))
        return (label, data, lengths, sym, run, rchars, tags)

    rows = ("rows of 0, 1, 31, 32, 33 symbols, no literal, literals only at the ends, "
            "runs of 255 and 256 and across tiles, all literals")
    cases = [case(f"{rows}, width {width}", *_run_lits(rng, width)),
             case(f"{rows}, width {width - 5} (byte loads and stores)",
                  *_run_lits(rng, width - 5))]
    if long_len:
        cases.append(case(f"rows of {long_len} symbols: runs of 65,535 and 65,536, "
                          "trailing runs over 65,535", *_long_lits(rng, long_len)))
    return cases


def token_planes(rows, lengths, rchar: int, pad: int = 16, extra: int = 0):
    """The (runs, lits) token planes (N, T) i32 of delQV-like ``rows`` (N, L)
    u8 up to ``lengths``, as the reference tokenizes them (Encode_Run,
    ``ops.bitstream.tokenize_runs``): a token per literal with the run of
    ``rchar`` before it, a trailing run without one (lit -1), then padding
    tokens (0, -1); T the most tokens of a row rounded up to ``pad``, plus
    ``extra``."""
    from .ops.bitstream import tokenize_runs

    toks = [tokenize_runs(rows[r, :lengths[r]], rchar) for r in range(len(lengths))]
    t = max((len(x[0]) for x in toks), default=0)
    t = -(-t // pad) * pad + extra
    runs = np.zeros((len(toks), t), np.int32)
    lits = np.full((len(toks), t), -1, np.int32)
    for r, (rl, sym, has) in enumerate(toks):
        runs[r, :len(rl)] = rl
        lits[r, :len(rl)] = np.where(has, sym, -1)
    return runs, lits


def expand_edge_cases(width: int = 9000, long_len: int = 0, seed: int = 37):
    """Edge inputs of K6 (ops/expand.expand_runs), NumPy: (label, runs (N, T)
    i32, lits (N, T) i32, rchar, max_len, tag_bytes (N, TB) u8 or None).
    The tokens (``token_planes``) of ``run_edge_rows(width, long_len)``'s
    delQV rows: rows of 0-33 symbols, no literal, literals only at the ends,
    runs of 255/256, dense rows, and with ``long_len`` runs of 65,535 and
    65,536 in rows of that many symbols.  Each with random tag bytes whose
    width stops short of the tokens (codes past 4 * TB read 0), at max_len
    the width (rows wider than a window) and at width - 37 (literals past
    max_len, a width no multiple of 16) with an odd token count and tag
    width (loads without 16-byte alignment), and without tags; and rows of
    sparse literals, four times as wide, with few tokens (a warp a row over
    many windows); and runs up to 2^31 - 1, whose columns pass 2^30 (where
    the kernel's column sums stop)."""
    rng = np.random.default_rng(seed)
    rc = EDGE_RCHAR

    def tags(runs, short):
        return rng.integers(0, 256, (runs.shape[0], max(runs.shape[1] // 4 - short, 0)),
                            dtype=np.uint8)

    label, data, lengths = run_edge_rows(width)[0][:3]
    cases = []
    runs, lits = token_planes(data[0], lengths, rc)
    cases.append((f"{label}: tags", runs, lits, rc, width, tags(runs, 3)))
    cases.append((f"{label}: no tags", runs, lits, rc, width, None))
    runs, lits = token_planes(data[0], lengths, rc, extra=3)
    cases.append((f"{label}: max_len {width - 37}, {runs.shape[1]} tokens, tags",
                  runs, lits, rc, width - 37, tags(runs, 5)))
    w4 = 4 * width
    sparse = np.where(rng.random((8, w4)) < 0.004, rng.integers(33, 80, (8, w4)), rc)
    sparse[0] = rc
    sparse[1, ::997] = 40
    slen = np.array([w4, w4, w4, w4 - 1, w4 // 3, 0, 1, w4], np.int64)
    runs, lits = token_planes(sparse.astype(np.uint8), slen, rc)
    cases.append((f"rows of {w4} symbols, sparse literals: tags", runs, lits, rc, w4,
                  tags(runs, 0)))
    huge = np.zeros((4, 5000), np.int32)
    hl = np.full((4, 5000), -1, np.int32)
    big = (1 << 31) - 1
    huge[0, :4], hl[0, :4] = [3, big, 0, 7], [40, 41, 42, 43]
    huge[1, :5], hl[1, :5] = [1 << 30, 1 << 30, 1, 0, 2], [44, -1, 45, 46, 47]
    huge[2, 600:603], hl[2, :700] = big, rng.integers(33, 80, 700)
    huge[3, 1:9], hl[3, :10] = [5, 0, 1, big, big, big, big, 9], np.arange(50, 60)
    cases.append(("runs up to 2^31 - 1 (columns past 2^30), 5,000 tokens a row: tags", huge,
                  hl, rc, 1000, tags(huge, 0)))
    if long_len:
        label, data, lengths = run_edge_rows(width, long_len)[-1][:3]
        runs, lits = token_planes(data[0], lengths, rc)
        cases.append((f"{label}: max_len {long_len - 37}, tags", runs, lits, rc,
                      long_len - 37, tags(runs, 1)))
    return cases


def tag_edge_cases(device, long_len: int = 70_000):
    """Edge inputs of K10 (ops/tag.tag_route_rows) on ``device``: (label,
    tag words (N, TBW) i32, state (N, max_len) i32, max_len).  The state
    comes from ``tag.tag_state`` on delQV rows with delChar 102 ('f').

    The cases: rows of 4,096 columns with a read of length 0, a full read,
    an all-kept and a none-kept read; a ``long_len``-symbol row (at the
    default 4,375 tag words, past 4,096), all kept and mostly kept; kept
    ranks past the row's words (4 words, 2,048 columns); widths that are no
    multiple of 128 (1,001, which is no multiple of 4 either, and 300); a
    state 4 bytes off 16-byte alignment; and rows without tag words."""
    import torch

    from .ops import tag

    rng = np.random.default_rng(29)
    dev = torch.device(device)
    del_char = 102
    cases = []

    def case(label, rlens, kept_share, tb, width):
        n = len(rlens)
        kept = rng.random((n, width)) < np.asarray(kept_share)[:, None]
        other = rng.integers(33, 80, (n, width))
        other[other == del_char] = 101
        del_rows = torch.from_numpy(np.where(kept, other, del_char).astype(np.uint8))
        state = tag.tag_state(del_rows, torch.as_tensor(rlens), del_char)
        words = tag.tag_words(torch.from_numpy(rng.integers(0, 256, (n, tb), dtype=np.uint8)))
        cases.append((label, words.to(dev), state.to(dev), width))

    w = 4096
    case("0, full, all-kept, none-kept and random reads of 4,096 columns",
         [0, w, 3000, 2500, 1234], [0.8, 0.8, 1.0, 0.0, 0.5], w // 4, w)
    case(f"{long_len}-symbol rows, {long_len // 16} tag words", [long_len, long_len - 3],
         [1.0, 0.75], long_len // 4, long_len)
    case("kept ranks past the row's 4 tag words", [2048, 2000, 65, 64], [1.0, 0.9, 1.0, 1.0],
         16, 2048)
    case("max_len 1,001 (no multiple of 128 or 4)", [1001, 0, 999, 500, 1000, 7],
         [0.8, 0.8, 1.0, 0.0, 0.6, 1.0], 250, 1001)
    case("max_len 300 (no multiple of 128)", [300, 1, 299, 150], [0.8, 1.0, 0.0, 0.7], 75, 300)
    label, words, state, width = cases[0]
    flat = torch.zeros(state.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(state.shape)                 # data_ptr % 16 == 4
    shifted.copy_(state)
    cases.append(("the first case's state 4 bytes off 16-byte alignment", words, shifted,
                  width))
    case("rows without tag words (TBW 0)", [64, 10, 0], [1.0, 0.5, 1.0], 3, 64)
    return cases


def lossy_quiva(quiva: bytes) -> bytes:
    """What a lossy .dexqv of ``quiva`` decodes to: insQV & 0xFE and
    mrgQV & 0xFC (QV.c:1049-1065)."""
    from .formats.quiva import parse_quiva, write_quiva

    q = parse_quiva(quiva)
    streams = q.streams.copy()
    streams[2] &= 0xFE
    streams[3] &= 0xFC
    return write_quiva(q.prefix, q.wells, q.begs, q.ends, q.qvs, q.lengths, streams)
