"""The decode kernels' plain twins (what the CUDA kernels K4, K5 and K6
compute) and the five-channel decode step against the JAX package's XLA
formulation (``dextractor_tpu.ops.decode2`` on the CPU, which
tests/test_decode_conveyor.py pins to the Pallas kernels).  The streams come
from the port's encode twins, whose per-row ``t``/``lg`` the decoder's
``bits``/``last`` must reproduce.  Integer codec: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.ops import decode2 as jd2

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.ops import decode2 as td2
from dextractor_tpu_torch.ops import decode_chains as dch
from dextractor_tpu_torch.ops import expand
from dextractor_tpu_torch.testing import (batch_to, check_decode_case, decode_batch,
                                          decode_edge_cases, make_quiva)
from dextractor_tpu_torch.utils import dispatch


@pytest.fixture(scope="module")
def cases():
    return {name: (fn, args, kw, expect) for name, fn, args, kw, expect
            in decode_edge_cases("cpu", long_len=2600)}


def _u32(x):
    return jnp.asarray(x.numpy().view(np.uint32))


def _pick(cases, fn, word):
    return next(v for k, v in cases.items() if v[0] == fn and word in k)


@pytest.mark.parametrize("which, held", [("C=4", (0, 2)), ("C=1", (0,)), ("pos0", (0,)),
                                         ("fixed 8-bit", (0,)),
                                         ("every symbol an escape", (0,))])
def test_plain_chains_match_xla(cases, which, held):
    """Four schemes (type-2 escapes, lmax 12/16 with L2, 0-bit codes) in one
    launch, lmax-12 tables alone, chains resumed at pos0, chains of 8-bit
    codes only (also resumed at pos0) and chains whose every symbol is an
    escape, in rows whose width is no multiple of 4.  Every channel
    must decode its encoded symbols; the channels ``held`` (one XLA compile
    each) must also equal the JAX chain."""
    _, (rects, rlens, f1, f2, sigs, subws), kw, expect = _pick(cases, "decode_plain", which)
    before = dict(dispatch.TWIN_CALLS)
    got = dch.decode_plain(rects, rlens, f1, f2, sigs, subws, **kw)
    assert dispatch.TWIN_CALLS["decode_plain"] == before["decode_plain"] + 1
    assert dispatch.LAUNCHES["decode_plain"] == 0
    check_decode_case(which, got, expect)
    pos0 = kw["pos0"]
    for c in held:
        ref = jd2.plain_chain(
            _u32(rects[c]), jnp.asarray(rlens.numpy()), jnp.asarray(f1[c].numpy()),
            jnp.asarray(f2.numpy()), jnp.int32(sigs[c]), max_len=kw["max_len"],
            subw=subws[c], lmax=kw["lmax"],
            pos0=None if pos0 is None else jnp.asarray(pos0[c].numpy()))
        assert np.array_equal(got[0][c].numpy(), np.asarray(ref)), c


@pytest.mark.parametrize("which", ["up to 65,535", "carry", "type-2"])
def test_run_chain_matches_xla(cases, which):
    """Runs over 255 (16-bit escapes), chains resumed inside a run (pos0 and
    carry), type-2 literal escapes; then K6's twin with tag codes against
    the XLA expand_del_tag and expand_runs2."""
    _, (rect, rlens, f1r, f1s, f2, nsig), kw, expect = _pick(cases, "decode_run", which)
    got = dch.decode_run(rect, rlens, f1r, f1s, f2, nsig, **kw)
    check_decode_case(which, got, expect)
    opt = {k: None if kw[k] is None else jnp.asarray(kw[k].numpy())
           for k in ("pos0", "carry")}
    xr, xl = (np.asarray(x) for x in jd2.run_chain(
        _u32(rect), jnp.asarray(rlens.numpy()), jnp.asarray(f1r.numpy()),
        jnp.asarray(f1s.numpy()), jnp.asarray(f2.numpy()), jnp.int32(nsig),
        max_tokens=kw["max_tokens"], subw=kw["subw"], lmax=kw["lmax"], **opt))
    runs, lits = got[0].numpy(), got[1].numpy()
    t = runs.shape[1]
    assert t == kw["max_tokens"] <= xr.shape[1]
    assert np.array_equal(runs, xr[:, :t]) and np.array_equal(lits, xl[:, :t])
    assert not xr[:, t:].any() and (xl[:, t:] == -1).all()

    rchar, width = expect["rchar"], expect["rows"].shape[1]
    rng = np.random.default_rng(4)
    tag_bytes = rng.integers(0, 256, (runs.shape[0], 40), dtype=np.uint8)
    rows, tags = expand.expand_runs(got[0], got[1], rchar, max_len=width,
                                    tag_bytes=torch.from_numpy(tag_bytes))
    codes = jd2._unpack_tag_codes(jnp.asarray(tag_bytes), t)
    r_rows, r_tags = jd2.expand_del_tag(jnp.asarray(runs), jnp.asarray(lits), codes,
                                        rchar, max_len=width)
    assert np.array_equal(rows.numpy(), np.asarray(r_rows))
    assert np.array_equal(tags.numpy().astype(np.int32), np.asarray(r_tags))
    rows2, none = expand.expand_runs(got[0], got[1], rchar, max_len=width)
    assert none is None
    ref2 = jd2.expand_runs2(jnp.asarray(runs), jnp.asarray(lits), jnp.uint8(rchar),
                            max_len=width)
    assert np.array_equal(rows2.numpy(), np.asarray(ref2))


def test_tag_unpack_and_letters_match_reference():
    tb = np.random.default_rng(6).integers(0, 256, (3, 9), dtype=np.uint8)
    for width in (20, 36, 50):
        got = td2._unpack_tag_codes(torch.from_numpy(tb), width).numpy()
        ref = np.asarray(jd2._unpack_tag_codes(jnp.asarray(tb), width))
        assert np.array_equal(got, ref)
        assert np.array_equal(td2._tag_letters(torch.from_numpy(got)).numpy(),
                              np.asarray(jd2._tag_letters(jnp.asarray(ref))))


MODES = {   # (del mode, sub mode) -> corpus
    ("run", "plain"): dict(seed=3, n_reads=30, max_len=600),
    ("run", "run"): dict(seed=3, n_reads=90, min_len=2200, max_len=2500, sub_heavy=True),
    ("plain", "plain"): dict(seed=3, n_reads=20, max_len=700, del_run=False),
}


@pytest.mark.parametrize("modes", list(MODES), ids="-".join)
def test_decode_entry_batch2_matches_reference(modes):
    kw = dict(MODES[modes])
    data = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    args, statics = decode_batch(tq.encode_quiva_to_dexqv(data, device=False))
    assert (statics["del_mode"], statics["sub_mode"]) == modes
    jargs = [jnp.asarray(a.view(np.uint32) if i in (0, 2, 3, 4) else a)
             for i, a in enumerate(args)]
    ref = np.asarray(jd2.decode_entry_batch2(*jargs, **statics))
    dispatch.reset_counts()
    got = td2.decode_entry_batch2(*batch_to(args, "cpu"), **statics)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)
    n_run = modes.count("run")
    assert dispatch.TWIN_CALLS["decode_plain"] == 1
    assert dispatch.TWIN_CALLS["decode_run"] == dispatch.TWIN_CALLS["expand_runs"] == n_run
    assert not any(dispatch.LAUNCHES.values())


def test_edge_cases_take_both_l2_reads(cases):
    """The CUDA chain kernels stage L2 in shared memory up to SMEM_L2_MAX
    entries and read it from global memory past that; the edge rows that
    chip_smoke holds them to must take both."""
    sizes = [args[3 if fn == "decode_plain" else 4].numel()
             for fn, args, kw, _ in cases.values()
             if (max(args[5]) if fn == "decode_plain" else kw["subw"])]
    assert min(sizes) <= dch.SMEM_L2_MAX < max(sizes)


def test_wrappers_refuse_what_they_cannot_run(cases):
    _, (rects, rlens, f1, f2, sigs, subws), kw, _ = _pick(cases, "decode_plain", "C=4")
    with pytest.raises(TypeError):
        dch.decode_plain([r.long() for r in rects], rlens, f1, f2, sigs, subws, **kw)
    with pytest.raises(ValueError):          # one channel more than a launch takes
        dch.decode_plain(rects + rects[:1], rlens, f1, f2, sigs + [256], subws + [0], **kw)
    with pytest.raises(ValueError):          # subw that does not match lmax
        dch.decode_plain(rects, rlens, f1, f2, sigs, [3] * 4, **kw)
    with pytest.raises(ValueError):          # no kernel and no fallback off CPU/CUDA
        dch.decode_plain([r.to("meta") for r in rects], rlens.to("meta"), f1.to("meta"),
                         f2.to("meta"), sigs, subws, **{**kw, "pos0": None})
    runs = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        expand.expand_runs(runs, runs[:1], 3, max_len=8)
    with pytest.raises(TypeError):
        expand.expand_runs(runs, runs, 3, max_len=8, tag_bytes=runs)
