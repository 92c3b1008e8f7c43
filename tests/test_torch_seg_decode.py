"""The checkpoint-segmented decode of long reads: the port's second lens walk
(``_index_checkpoints``), its flat segment launch (``build_seg_launch_flat``)
and its segmented step (``decode_entry_batch_seg``) against the JAX
package's, and ``decode_dexqv_to_quiva(device="cpu")`` on both routes
against the original and the JAX package's decoder.  Integer codec: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.codecs import qv_batch as jqb
from dextractor_tpu.codecs import qv_codec as jqc
from dextractor_tpu.codecs.qv_codec import decode_dexqv_to_quiva as jax_decode
from dextractor_tpu.formats import dexqv as jdq
from dextractor_tpu.ops import decode2 as jd2

from dextractor_tpu_torch.codecs import qv_batch as tqb
from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.ops import decode2 as td2
from dextractor_tpu_torch.testing import lossy_quiva, make_quiva
from dextractor_tpu_torch.utils import dispatch

CORPORA = {   # name -> (make_quiva arguments, lossy)
    "run_del": (dict(seed=5, lengths=[4200, 2049, 0, 2048, 3]), False),
    "plain_del": (dict(seed=1, lengths=[4200, 100, 2500], del_run=False), False),
    "sub_heavy_lossy": (dict(seed=3, n_reads=90, min_len=2200, max_len=2500,
                             sub_heavy=True), True),
}


@pytest.fixture(scope="module")
def encoded():
    out = {}
    for name, (kw, lossy) in CORPORA.items():
        kw = dict(kw)
        data = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
        out[name] = (data, lossy, tq.encode_quiva_to_dexqv(data, lossy=lossy, device=False))
    return out


def _both(enc):
    """(port's walk results and checkpoints, JAX package's coding and
    checkpoints) of a .dexqv image."""
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    idx = tq._index_native(enc, coding, off, True)
    ck = tq._index_checkpoints(enc, coding, off, True, idx[5])
    jcoding, joff = jdq.parse_qvcoding(memoryview(enc), 2)
    jck = jqc._index_checkpoints(enc, jcoding, joff, True,
                                 jqc._index_native(enc, jcoding, joff, True))
    return coding, idx, ck, jcoding, jck


def _launch_args(enc, coding, idx, ck):
    _, _, _, _, eoffs, elens, coffs, ntoks = idx
    return (np.frombuffer(enc, np.uint8), eoffs, elens.astype(np.int32), coffs, ntoks)


@pytest.mark.parametrize("name", list(CORPORA))
def test_checkpoints_and_flat_launch_match_reference(encoded, name):
    """Checkpoint arrays, segment rectangles, pos0, carries, rlens, widths
    and the tag input equal the JAX package's; with delQV RLE the port's
    tag bytes unpack to the JAX package's per-segment codes."""
    _, _, enc = encoded[name]
    coding, idx, ck, jcoding, jck = _both(enc)
    for a, b in zip(ck, jck):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    la = _launch_args(enc, coding, idx, ck)
    args, statics, rid, kseg = tqb.build_seg_launch_flat(*la, coding, ck)
    jargs, jstatics, jrid, jkseg = jqb.build_seg_launch_flat(*la, jcoding, jck)
    assert np.array_equal(rid, jrid) and np.array_equal(kseg, jkseg)
    assert statics == {k: jstatics[k] for k in ("max_tokens", "del_mode", "sub_mode")} | \
        {"seg": jstatics["seg"]}
    assert jstatics["s_per"] == 1 and jstatics["max_len"] == statics["seg"]
    jargs = list(jargs)
    assert np.array_equal(jargs.pop(5), jargs[5])       # the flat rlens are seg_rlens
    for i, (a, b) in enumerate(zip(args, jargs)):
        if i == 1 and coding.del_char >= 0:
            a = td2._unpack_tag_codes(torch.from_numpy(a), b.shape[1]).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), i
    live = kseg >= 1
    if coding.del_char >= 0:      # checkpoints at kept ranks t0 % 4 != 0, inside runs
        t0 = ck[3][0][np.clip(ck[1][rid] + kseg - 1, 0, None)]
        assert (t0[live] % 4 != 0).any()
        assert (args[7][0][live] >= 0).any()
    if coding.sub_char >= 0:
        assert (args[7][1][live] >= 0).any()


@pytest.mark.parametrize("name", list(CORPORA))
def test_segmented_step_matches_reference(encoded, name):
    _, _, enc = encoded[name]
    coding, idx, ck, jcoding, jck = _both(enc)
    la = _launch_args(enc, coding, idx, ck)
    args, statics, _, _ = tqb.build_seg_launch_flat(*la, coding, ck)
    jargs, jstatics, _, _ = jqb.build_seg_launch_flat(*la, jcoding, jck)
    sids, f1, f2, types, _, _, subw, lmax = tqb.decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    dispatch.reset_counts()
    got = td2.decode_entry_batch_seg(
        *(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args),
        sids, torch.from_numpy(f1), torch.from_numpy(f2), types, coding.del_char & 0xFF,
        coding.sub_char & 0xFF, subw=subw, lmax=lmax, chan_l2=chan_l2, **statics)
    assert dispatch.TWIN_CALLS["decode_plain"] == 1 and not any(dispatch.LAUNCHES.values())
    assert dispatch.TWIN_CALLS["decode_run"] == (coding.del_char >= 0) + (coding.sub_char >= 0)
    ref = jd2.decode_entry_batch_seg(
        *(jnp.asarray(a) for a in jargs), jnp.asarray(sids), jnp.asarray(f1),
        jnp.asarray(f2), jnp.asarray(types), jnp.int32(coding.del_char & 0xFF),
        jnp.int32(coding.sub_char & 0xFF), subw=subw, lmax=lmax, chan_l2=chan_l2,
        **jstatics)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seg_decode", ["1", "0"])
@pytest.mark.parametrize("name", list(CORPORA))
def test_decode_routes_match_original_and_reference(encoded, name, seg_decode,
                                                    monkeypatch):
    """DXT_SEG_DECODE unset or "1": the segmented route; "0": one chain per
    read.  Both give the original bytes and the JAX package's."""
    data, lossy, enc = encoded[name]
    calls = {"seg": 0, "per_read": 0}
    seg, per_read = tqb.fused_decode_entries_seg, tqb.fused_decode_entries

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tqb, "fused_decode_entries_seg", count("seg", seg))
    monkeypatch.setattr(tqb, "fused_decode_entries", count("per_read", per_read))
    if seg_decode == "0":
        monkeypatch.setenv("DXT_SEG_DECODE", "0")
    else:
        monkeypatch.delenv("DXT_SEG_DECODE", raising=False)
    want = lossy_quiva(data) if lossy else data
    assert tq.decode_dexqv_to_quiva(enc, device="cpu") == want == jax_decode(enc, device=False)
    assert calls == ({"seg": 1, "per_read": 0} if seg_decode == "1"
                     else {"seg": 0, "per_read": 1})


def test_short_reads_take_the_per_read_route(monkeypatch):
    data = make_quiva(np.random.default_rng(8), lengths=[2048, 0, 700, 1999])
    enc = tq.encode_quiva_to_dexqv(data, device=False)
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    assert tq._index_checkpoints(enc, coding, off, True, np.array([2048, 0, 700, 1999])) \
        is None
    monkeypatch.setattr(tqb, "fused_decode_entries_seg", None)   # would raise if called
    assert tq.decode_dexqv_to_quiva(enc, device="cpu") == data
