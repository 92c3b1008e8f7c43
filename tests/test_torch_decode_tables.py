"""Port vs JAX package: the decode side of the Huffman schemes, the container
coding, and the two-level decode tables.  Host numpy on both sides, so
every comparison is exact."""

import numpy as np
import pytest

from dextractor_tpu.codecs import qv_batch as jqb
from dextractor_tpu.formats import dexqv as jdq
from dextractor_tpu.ops import decode2 as jd2
from dextractor_tpu.ops import huffman as jh

from dextractor_tpu_torch.codecs import qv_batch as tqb
from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.ops import decode2 as td2
from dextractor_tpu_torch.ops import huffman as th
from dextractor_tpu_torch.testing import edge_schemes, make_quiva

# scheme -> the lmax bucket of its decode tables
KINDS = {"lmax8": 8, "lmax12": 12, "lmax16": 16, "type2": 16, "zero_bit": 8,
         "run": 12}


def _flipped(scheme) -> bytes:
    """Write_Scheme of a big-endian host: each code big-endian."""
    out = bytearray([scheme.type])
    for i in range(256):
        out.append(int(scheme.codelens[i]))
        if scheme.codelens[i]:
            out += int(scheme.codebits[i]).to_bytes(4, "big")
    return bytes(out)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_parse_scheme_and_tables_match_reference(kind, flip):
    made = edge_schemes()[kind][0]
    raw = _flipped(made) if flip else th.scheme_bytes(made)
    buf = memoryview(b"\x07" + raw + b"\x00")
    got, g_off = th.parse_scheme(buf, 1, flip)
    ref, r_off = jh.parse_scheme(buf, 1, flip)
    assert g_off == r_off == 1 + len(raw)
    assert got.type == ref.type
    for f in ("codelens", "codebits", "lookup"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    g_f1, g_f2, g_subw, g_lmax = td2.scheme_tables2([got])
    r_f1, r_f2, r_subw, r_lmax = jd2.scheme_tables2([ref])
    assert (g_subw, g_lmax) == (r_subw, r_lmax)
    assert g_lmax == KINDS[kind]
    assert np.array_equal(g_f1, r_f1) and np.array_equal(g_f2, r_f2)
    if kind == "type2":
        assert got.type == 2
    if kind == "zero_bit":
        assert got.codelens.max() == 0


CORPORA = {
    "run_del": dict(seed=1, n_reads=20, max_len=600),
    "plain_del": dict(seed=2, n_reads=12, max_len=300, del_run=False),
}


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("name", list(CORPORA))
def test_parse_qvcoding_and_decode_tables_match_reference(name, lossy):
    kw = dict(CORPORA[name])
    data = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    enc = tq.encode_quiva_to_dexqv(data, lossy=lossy, device=False)
    for image, off in ((enc, 2), (enc[2:], 0)):       # legacy: no container key
        got, g_off = tdq.parse_qvcoding(memoryview(image), off)
        ref, r_off = jdq.parse_qvcoding(memoryview(image), off)
        assert g_off == r_off
        assert (got.del_char, got.sub_char, got.prefix, got.flip) == \
            (ref.del_char, ref.sub_char, ref.prefix, ref.flip)
        assert tdq.qvcoding_bytes(got) == jdq.qvcoding_bytes(ref)
    g_tab = tqb.decode_tables_v2(got)
    r_tab = jqb.decode_tables_v2(ref)
    for a, b in zip(g_tab, r_tab):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the JAX coding carried across decodes to the same tables
    carried = tdq.coding_from_reference(ref)
    assert tdq.qvcoding_bytes(carried) == jdq.qvcoding_bytes(ref)
    for a, b in zip(tqb.decode_tables_v2(carried), r_tab):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_channel_rects_and_span_buckets_match_reference():
    data = make_quiva(np.random.default_rng(4), lengths=[100, 2500, 0, 300, 1200, 1])
    enc = tq.encode_quiva_to_dexqv(data, device=False)
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    _, _, _, _, eoffs, elens, coffs, ntoks = tq._index_native(enc, coding, off, True)
    buf = np.frombuffer(enc, np.uint8)
    for a, b in zip(tqb.channel_rects(buf, eoffs, coffs, 2560),
                    jqb.channel_rects(buf, eoffs, coffs, 2560)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    keys = tqb.span_buckets(coffs)
    assert np.array_equal(keys, jqb.span_buckets(coffs))
    assert len(np.unique(keys)) > 1          # this corpus splits into launches
