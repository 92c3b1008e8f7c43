"""The port's v1 batch decoders (``dextractor_tpu_torch.ops.decode_torch``:
``decode_plain_batch``, ``decode_run_batch``, ``expand_runs_np``) and their
sharded wrappers (``parallel.pipeline.sharded_decode_plain``/``_run``)
against the JAX package's ``ops/decode_jax.py`` on the CPU, where the
port's K4b/K5 wrappers run their twins.

The streams are encoded by the JAX package's host encoder
(``ops/bitstream.py``) and laid out in one image at unaligned byte offsets,
random bytes between them, the last ending at the image's end.  Cases:
several schemes in one call, a type-2 scheme whose rare symbols escape, a
one-symbol scheme (zero-length codes, ROADMAP F3/F5), streams of 0
symbols, runs of 255, 256 and 65,535, and ``max_len``/``max_tokens``
below a stream's need.  Integer codec: every output is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.ops import bitstream as bs
from dextractor_tpu.ops import decode_jax as dj
from dextractor_tpu.ops.huffman import make_scheme

from dextractor_tpu_torch.ops import decode_torch as dt
from dextractor_tpu_torch.parallel import pipeline as pl
from dextractor_tpu_torch.parallel.mesh import make_mesh
from dextractor_tpu_torch.utils import dispatch

RCHAR = 70


def _tables(schemes):
    for s in schemes:
        s.with_lookup()
    return (np.stack([s.lookup for s in schemes]).astype(np.int32),
            np.stack([s.codelens for s in schemes]).astype(np.int32),
            np.array([s.type for s in schemes], np.int32))


def _layout(chunks, rng):
    """One image of the streams at unaligned offsets: 1-6 random bytes
    before each, none after the last."""
    parts, starts, pos = [], [], 0
    for c in chunks:
        gap = int(rng.integers(1, 7))
        parts.append(rng.integers(0, 256, gap).astype(np.uint8).tobytes())
        pos += gap
        starts.append(pos)
        parts.append(c)
        pos += len(c)
    return np.frombuffer(b"".join(parts), np.uint8), np.array(starts, np.int64)


@pytest.fixture(scope="module")
def plain_case():
    """12 plain streams of three schemes (a full one, a type-2 one whose
    rare symbols escape, a one-symbol one), two of 0 symbols."""
    rng = np.random.default_rng(5)
    full = make_scheme(np.bincount(rng.integers(33, 90, 5000), minlength=256))
    deep = np.zeros(256, np.int64)
    deep[40:64] = 1 << (24 - np.arange(24))          # exponential counts: deep codes
    escape = make_scheme(deep)
    assert escape.type == 2
    one = np.zeros(256, np.int64)
    one[50] = 100
    schemes = [full, escape, make_scheme(one)]
    alphabets = [np.arange(33, 90), np.arange(40, 64), np.array([50])]
    sids = np.array([0, 1, 2, 0, 1, 2, 0, 1, 0, 1, 2, 0], np.int32)
    rlens = np.array([120, 260, 33, 0, 300, 7, 1, 0, 97, 31, 200, 211], np.int32)
    chunks, datas = [], []
    for sid, ln in zip(sids, rlens):
        d = rng.choice(alphabets[sid], ln).astype(np.uint8)
        datas.append(d)
        chunks.append(bs.encode_stream(schemes[sid], d).tobytes() if ln else b"")
    buf, starts = _layout(chunks, rng)
    return buf, starts, rlens, sids, _tables(schemes), datas


def _run_data(rng, ln, runs=()):
    """A delQV-like row of ``ln`` symbols: runs of RCHAR between literals,
    with the run lengths ``runs`` placed first."""
    out = []
    for r in runs:
        out += [RCHAR] * r + [int(rng.integers(33, 60))]
    while len(out) < ln:
        out += [RCHAR] * int(rng.integers(0, 9)) + [int(rng.integers(33, 60))]
    return np.array(out[:ln], np.uint8)


@pytest.fixture(scope="module")
def run_case():
    """9 RLE streams of two (symbol, run) scheme pairs: runs of 255, 256 and
    65,535, a stream that ends in a run, one of 0 symbols."""
    rng = np.random.default_rng(6)
    specs = [(0, 300, ()), (1, 700, (255, 256)), (0, 66_000, (65_535,)), (1, 0, ()),
             (0, 40, ()), (1, 2, ()), (0, 520, (256, 255, 3)), (1, 150, ()), (0, 90, ())]
    datas = [_run_data(rng, ln, runs) for _, ln, runs in specs]
    datas[4][-12:] = RCHAR                            # a trailing run
    schemes, pairs = [], []
    for pair in range(2):
        rows = [d for (p, _, _), d in zip(specs, datas) if p == pair]
        flat = np.concatenate(rows)
        nhist = np.bincount(flat[flat != RCHAR], minlength=256)
        if pair == 1:                                 # skewed: a type-2 literal scheme
            nhist = np.where(nhist > 0, 1 << np.clip(np.arange(256) - 32, 0, 24), 0)
        rhist = np.ones(256, np.int64)
        for d in rows:
            rhist += np.bincount(np.minimum(bs.tokenize_runs(d, RCHAR)[0], 255),
                                 minlength=256)
        schemes += [make_scheme(nhist), make_scheme(rhist)]
        pairs.append((2 * pair, 2 * pair + 1))
    assert schemes[2].type == 2
    sym_ids = np.array([pairs[p][0] for p, _, _ in specs], np.int32)
    run_ids = np.array([pairs[p][1] for p, _, _ in specs], np.int32)
    chunks = [bs.encode_run_stream(schemes[s], schemes[r], d, RCHAR).tobytes()
              for s, r, d in zip(sym_ids, run_ids, datas)]
    buf, starts = _layout(chunks, rng)
    rlens = np.array([len(d) for d in datas], np.int32)
    ntok = max(len(bs.tokenize_runs(d, RCHAR)[0]) for d in datas if len(d))
    return buf, starts, rlens, sym_ids, run_ids, _tables(schemes), datas, ntok


def _jax_plain(case, max_len):
    buf, starts, rlens, sids, (look, lens, types), _ = case
    return [np.asarray(x) for x in dj.decode_plain_batch(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(rlens), jnp.asarray(sids),
        jnp.asarray(look), jnp.asarray(lens), jnp.asarray(types), max_len=max_len)]


def _jax_run(case, max_tokens):
    buf, starts, rlens, sym_ids, run_ids, (look, lens, types), _, _ = case
    return [np.asarray(x) for x in dj.decode_run_batch(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(rlens), jnp.asarray(sym_ids),
        jnp.asarray(run_ids), jnp.asarray(look), jnp.asarray(lens), jnp.asarray(types),
        max_tokens=max_tokens)]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("max_len", [300, 100])
def test_decode_plain_batch_matches_jax(plain_case, max_len):
    """Every output, total_bits and last_gran included, equals the JAX
    package's, for the whole streams and cut at max_len 100; the symbols
    are the data (the one-symbol scheme's as zeros, F5)."""
    buf, starts, rlens, sids, (look, lens, types), datas = plain_case
    dispatch.reset_counts()
    got = dt.decode_plain_batch(buf, starts, rlens, sids, look, lens, types,
                                max_len=max_len, device="cpu")
    assert dispatch.TWIN_CALLS["decode_plain"] >= 3         # one group per scheme, at least
    want = _jax_plain(plain_case, max_len)
    _assert_equal(got, want)
    for i, d in enumerate(datas):
        n = min(len(d), max_len)
        expect = d[:n] if sids[i] != 2 else np.zeros(n, np.uint8)
        np.testing.assert_array_equal(want[0][i, :n], expect)
    if max_len >= rlens.max():
        words = dj.stream_word_counts(want[1], want[2])
        assert (words[:-1] * 4 <= np.diff(starts)).all()


@pytest.mark.parametrize("cut", [False, True])
def test_decode_run_batch_matches_jax(run_case, cut):
    """Every output of the RLE decode equals the JAX package's, n_tokens
    (the symbols carried, capped at rlen) included, whole and with
    max_tokens below the longest stream's need; expanded, the whole decode
    is the data."""
    buf, starts, rlens, sym_ids, run_ids, (look, lens, types), datas, ntok = run_case
    max_tokens = ntok // 3 if cut else ntok + 3
    dispatch.reset_counts()
    got = dt.decode_run_batch(buf, starts, rlens, sym_ids, run_ids, look, lens, types,
                              max_tokens=max_tokens, device="cpu")
    assert dispatch.TWIN_CALLS["decode_run"] >= 2
    want = _jax_run(run_case, max_tokens)
    _assert_equal(got, want)
    runs, lits = want[0], want[1]
    mine = dt.expand_runs_np(got[0].numpy(), got[1].numpy(), rlens, RCHAR)
    np.testing.assert_array_equal(mine, dj.expand_runs_np(runs, lits, rlens, RCHAR))
    if not cut:
        for i, d in enumerate(datas):
            np.testing.assert_array_equal(mine[i, :len(d)], d)
        np.testing.assert_array_equal(want[2], rlens)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_decode_plain_and_run(plain_case, run_case, shards):
    """sharded_decode_plain/_run on a CPU mesh of 1, 3 and 8 shards (12
    and 9 streams: no multiple of 8) equal the JAX package's unsharded
    decoders."""
    buf, starts, rlens, sids, (look, lens, types), _ = plain_case
    mesh = make_mesh(shards, "cpu")
    got = pl.sharded_decode_plain(mesh, max_len=300)(buf, starts, rlens, sids, look, lens,
                                                     types)
    _assert_equal(got, _jax_plain(plain_case, 300))
    buf, starts, rlens, sym_ids, run_ids, (look, lens, types), _, ntok = run_case
    got = pl.sharded_decode_run(mesh, max_tokens=ntok + 3)(
        buf, starts, rlens, sym_ids, run_ids, look, lens, types)
    _assert_equal(got, _jax_run(run_case, ntok + 3))


def test_v1_decoders_raise_on_cuda_without_a_card(plain_case, monkeypatch):
    """device="cuda", or no device (the card), on a host with no card
    raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf, starts, rlens, sids, (look, lens, types), _ = plain_case
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.decode_plain_batch(buf, starts, rlens, sids, look, lens, types, max_len=8,
                                  device=device)
