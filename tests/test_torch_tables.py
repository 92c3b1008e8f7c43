"""Port vs JAX package: Huffman schemes, packed LUTs and the file coding.

Everything here is host numpy on both sides, so the comparison is exact.
"""

import numpy as np
import pytest

from dextractor_tpu.codecs import qv_codec as jq
from dextractor_tpu.formats import dexqv as jdq
from dextractor_tpu.formats.quiva import parse_quiva
from dextractor_tpu.ops import bitstream_jax as bj
from dextractor_tpu.ops import huffman as jh

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.ops import bitstream_torch as bt
from dextractor_tpu_torch.ops import huffman as th
from dextractor_tpu_torch.testing import make_quiva


def _hist(kind):
    rng = np.random.default_rng(5)
    h = np.zeros(256, np.int64)
    if kind == "uniform":
        h[:] = rng.integers(1, 100, 256)
    elif kind == "concentrated":          # geometric counts: depth > 16, type 2
        h[:] = 1
        h[:40] += (1.6 ** np.arange(40)).astype(np.int64)
    elif kind == "single":                # one symbol: a zero-length code
        h[ord("f")] = 1234
    elif kind == "sparse":
        h[[3, 40, 41, 200, 255]] = [7, 1, 1, 90, 2]
    elif kind == "run":                   # a run histogram (init 1, QV.c:934)
        h[:] = 1
        h[:4] = 50_000
    return h


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "single", "sparse", "run"])
def test_make_scheme_matches_reference(kind):
    h = _hist(kind)
    ref, got = jh.make_scheme(h), th.make_scheme(h)
    assert got.type == ref.type
    assert np.array_equal(got.codelens, ref.codelens)
    assert np.array_equal(got.codebits, ref.codebits)
    assert th.scheme_bytes(got) == jh.scheme_bytes(ref)
    for run in (False, True):
        assert np.array_equal(bt.scheme_luts(got, run=run),
                              bj.scheme_luts(ref, run=run))
    if kind == "concentrated":
        assert got.type == 2
    if kind == "single":
        assert got.codelens.max() == 0


def test_scheme_luts_refuses_emissions_over_32_bits():
    s = th.HScheme(2, np.full(256, 25, np.int32), np.zeros(256, np.uint32))
    with pytest.raises(ValueError):
        bt.scheme_luts(s)


CORPORA = {
    "default": dict(seed=1, n_reads=20, max_len=600),
    "no_del_run": dict(seed=2, n_reads=12, max_len=300, del_run=False),
    "sub_heavy": dict(seed=3, n_reads=30, min_len=6700, max_len=7000, sub_heavy=True),
}


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, kw in CORPORA.items():
        kw = dict(kw)
        out[name] = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    return out


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("name", list(CORPORA))
def test_create_qvcoding_matches_reference(corpora, name, lossy):
    q = parse_quiva(corpora[name])
    ref_stats, got_stats = jq.scan_quiva(q), tq.scan_quiva(q)
    for f in ("del_hist", "ins_hist", "mrg_hist", "sub_hist", "del_run", "sub_run"):
        assert np.array_equal(getattr(got_stats, f), getattr(ref_stats, f)), f
    for f in ("del_char", "sub_char", "tot_char"):
        assert getattr(got_stats, f) == getattr(ref_stats, f), f
    ref = jq.create_qvcoding(ref_stats, q.prefix, lossy)
    got = tq.create_qvcoding(got_stats, q.prefix, lossy)
    assert (got.del_char, got.sub_char) == (ref.del_char, ref.sub_char)
    assert tdq.qvcoding_bytes(got) == jdq.qvcoding_bytes(ref)
    assert tdq.qvcoding_bytes(tdq.coding_from_reference(ref)) == jdq.qvcoding_bytes(ref)
    if name == "sub_heavy":     # both RLE channels are live (QV.c:1044-1045)
        assert got.drun_scheme is not None and got.srun_scheme is not None
