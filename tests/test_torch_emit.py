"""The kernels' plain twins (what the CUDA kernels K1-K3 compute) against
the JAX package's XLA formulation, which tests/test_emit_pallas.py pins to
the Pallas kernels.  Integer codec: every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.ops import bitstream_jax as bj
from dextractor_tpu.parallel import pipeline as jp
from dextractor_tpu.ops.twobit import NUMBER_BASE_LUT

from dextractor_tpu_torch.ops import bitstream_torch as bt
from dextractor_tpu_torch.ops import emit
from dextractor_tpu_torch.ops import huffman as th
from dextractor_tpu_torch.testing import EDGE_RCHAR, run_edge_rows
from dextractor_tpu_torch.utils import dispatch

RCHAR = ord("f")


@jax.jit
def _jax_plain(d, ln, luts):
    v, n, t, lg = bj.plain_emissions(d, ln, luts)
    return (bj.pack_words(v, n), t, lg) + bj.word_counts(t, lg)


@jax.jit
def _jax_run(d, ln, rchar, sl, rl):
    v, n, t, lg = bj.run_emissions(d, ln, rchar, sl, rl)
    return (bj.pack_words(v, n), t, lg) + bj.word_counts(t, lg)


_jax_tags = jax.jit(jp._pack_tags)


def _scheme(kind):
    h = np.ones(256, np.int64)
    if kind == "concentrated":            # type 2: escapes fire
        h[:40] += (1.6 ** np.arange(40)).astype(np.int64)
    else:
        h[:] = np.random.default_rng(1).integers(1, 100, 256)
    return th.make_scheme(h)


def _run_scheme():
    h = np.ones(256, np.int64)
    h[:4] = 50_000                        # long runs take the 16-bit escape
    return th.make_scheme(h)


def _rows(n=16, l=1024, seed=0):
    """Rows covering empty, full, all-rchar, runs over 255, one symbol,
    dense and sparse literals."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, (n, l)).astype(np.uint8)
    sparse = rng.random((n, l)) < 0.8
    d[6:] = np.where(sparse[6:], RCHAR, d[6:])
    d[2] = RCHAR                          # all-rchar: trailing run only
    d[3] = RCHAR
    d[3, ::300] = 40                      # runs of 299
    lengths = rng.integers(0, l + 1, n).astype(np.int32)
    lengths[[0, 1, 2, 3, 4]] = [0, l, l, l, 1]
    return d, lengths


def _compare_words(got, ref, raw):
    """Rows are compared up to raw; both sides hold zeros beyond."""
    assert got.shape == ref.shape
    for i, r in enumerate(raw):
        assert np.array_equal(got[i, :r], ref[i, :r]), f"row {i} words differ"
        assert not got[i, r:].any() and not ref[i, r:].any()


def _check(got, ref):
    words, t, lg = (x[0].numpy() for x in got)
    raw, out, dup, zext = (x.numpy() for x in bt.word_counts(got[1][0], got[2][0]))
    r_words, r_t, r_lg, r_raw, r_out, r_dup, r_zext = (np.asarray(x) for x in ref)
    assert np.array_equal(t, r_t) and np.array_equal(lg, r_lg)
    for a, b in ((raw, r_raw), (out, r_out), (dup, r_dup), (zext, r_zext)):
        assert np.array_equal(a, b)
    _compare_words(words.view(np.uint32), r_words, raw)


@pytest.mark.parametrize("kind", ["normal", "concentrated"])
def test_plain_twin_matches_xla(kind):
    d, ln = _rows()
    luts = bt.scheme_luts(_scheme(kind))
    ref = _jax_plain(d, ln, luts)
    before = dict(dispatch.TWIN_CALLS)
    got = emit.encode_plain(torch.from_numpy(d)[None], torch.from_numpy(ln),
                            torch.from_numpy(luts)[None])
    assert dispatch.TWIN_CALLS["encode_plain"] == before["encode_plain"] + 1
    _check(got, ref)


@functools.lru_cache(maxsize=None)
def _edge_rows():
    """testing.run_edge_rows at width 1,200 and at 1,195 (no multiple of 4)."""
    return run_edge_rows(1200)


@pytest.mark.parametrize("kind", ["normal", "concentrated", "edge", "edge_ragged"])
def test_run_twin_matches_xla(kind):
    """Random rows under two symbol schemes, and the edge rows of
    testing.run_edge_rows at two widths, each of their four channels with
    its own symbol and run scheme."""
    if kind.startswith("edge"):
        _, data, ln, sym, run, rch, _ = _edge_rows()[kind == "edge_ragged"]
    else:
        d, ln = _rows(seed=1)
        data, rch = d[None], np.array([RCHAR], np.int32)
        sym = bt.scheme_luts(_scheme(kind))[None]
        run = bt.scheme_luts(_run_scheme(), run=True)[None]
    got = emit.encode_run(*(torch.from_numpy(a) for a in (data, ln, sym, run, rch)))
    for c in range(data.shape[0]):
        ref = _jax_run(data[c], ln, rch[c], sym[c], run[c])
        _check(tuple(x[c:c + 1] for x in got), ref)


def test_run_twin_run_over_65535():
    """One 70,000-symbol row: a run of 66,000 before a literal and a
    trailing run, both escaped with run & 0xFFFF (ROADMAP F3)."""
    l = 70_000
    d = np.full((1, l), RCHAR, np.uint8)
    d[0, 66_000] = 40
    ln = np.array([l], np.int32)
    sl = bt.scheme_luts(_scheme("normal"))
    rl = bt.scheme_luts(_run_scheme(), run=True)
    ref = _jax_run(d, ln, np.int32(RCHAR), sl, rl)
    got = bt.encode_run_ref(torch.from_numpy(d)[None], torch.from_numpy(ln),
                            torch.from_numpy(sl)[None], torch.from_numpy(rl)[None],
                            torch.tensor([RCHAR], dtype=torch.int32))
    _check(got, ref)


@pytest.mark.parametrize("del_char, rows", [
    pytest.param(RCHAR, "random", id=str(RCHAR)), pytest.param(-1, "random", id="-1"),
    *(pytest.param(dc, rows, id=f"{dc}-{rows}")
      for rows in ("edge", "edge_ragged") for dc in (EDGE_RCHAR, -1))])
def test_pack_tags_twin_matches_xla(del_char, rows):
    """Random rows, and the edge rows of testing.run_edge_rows at two widths
    (no tag kept, every tag kept, lengths 0-33), with delChar and with -1
    (every tag kept)."""
    if rows == "random":
        d, ln = _rows(seed=2)
        rng = np.random.default_rng(3)
        tags = rng.choice(np.frombuffer(b"acgtn", np.uint8), size=d.shape)
    else:
        _, data, ln, _, _, _, tags = _edge_rows()[rows == "edge_ragged"]
        d = np.ascontiguousarray(data[0])
    # the JAX package packs whole bytes of 4 columns: pad the rows past
    # every length to a multiple of 4, which keeps ceil(L/4) bytes a row
    pad = ((0, 0), (0, -d.shape[1] % 4))
    ref_p, ref_c = _jax_tags(np.pad(tags, pad), np.pad(d, pad), ln, jnp.int32(del_char),
                             NUMBER_BASE_LUT)
    got_p, got_c = emit.pack_tags(
        torch.from_numpy(tags), torch.from_numpy(d), torch.from_numpy(ln),
        torch.tensor([del_char], dtype=torch.int32), torch.from_numpy(NUMBER_BASE_LUT))
    assert np.array_equal(got_c.numpy(), np.asarray(ref_c))
    assert np.array_equal(got_p.numpy(), np.asarray(ref_p))


def test_wrappers_refuse_what_they_cannot_run():
    d = torch.zeros((1, 2, 8), dtype=torch.uint8)
    ln = torch.zeros(2, dtype=torch.int32)
    luts = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(TypeError):
        emit.encode_plain(d.long(), ln, luts)
    with pytest.raises(ValueError):
        emit.encode_plain(d, ln[:1], luts)
    with pytest.raises(ValueError):
        emit.encode_plain(d.transpose(1, 2).contiguous().transpose(1, 2), ln, luts)
    with pytest.raises(ValueError):     # no kernel and no fallback off CPU/CUDA
        emit.encode_plain(d.to("meta"), ln.to("meta"), luts.to("meta"))
