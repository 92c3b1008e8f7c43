"""The encode step's emission route: the plain twins of K9 (lut_gather and
its grouped form lut_gather_groups) and K8 (pack_words) against the JAX
package's Pallas kernels in interpret mode and its XLA formulations, the
port's qv_encode_step on buckets that ``fused_ok`` sends past K1/K2 against
the JAX package's step, and a file with reads over 8,192 symbols.  Integer
codec: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dextractor_tpu.codecs.qv_codec import encode_quiva_to_dexqv as jax_encode
from dextractor_tpu.formats.ragged import bucket_len as jax_bucket_len
from dextractor_tpu.formats.ragged import pad_rows as jax_pad_rows
from dextractor_tpu.ops import bitstream_jax as bj
from dextractor_tpu.ops.emit_pallas import fused_ok as jax_fused_ok
from dextractor_tpu.ops.lut_pallas import lut_gather_lane, lut_gather_pallas
from dextractor_tpu.ops.pack_pallas import pack_words_pallas
from dextractor_tpu.parallel import qv_encode_step as jax_step

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.ops import emit
from dextractor_tpu_torch.ops import lut
from dextractor_tpu_torch.parallel import pipeline as tp
from dextractor_tpu_torch.testing import make_quiva
from dextractor_tpu_torch.utils import dispatch


def _table(seed=0):
    """A (256,) int32 table below 2^24 (lut_gather_pallas sums in float32)."""
    return np.random.default_rng(seed).integers(0, 1 << 24, 256).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_lut_gather_twin_matches_pallas(dtype):
    """u8 symbols (every value) and int32 run indices 0-255, through the
    wrapper on the CPU (its twin) against both Pallas kernels and the XLA
    lookup."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (7, 301)).astype(dtype)
    data[0, :256] = np.arange(256)
    table = _table()
    dispatch.reset_counts()
    got = lut.lut_gather(torch.from_numpy(data), torch.from_numpy(table))
    assert dispatch.TWIN_CALLS["lut_gather"] == 1 and not any(dispatch.LAUNCHES.values())
    assert got.dtype == torch.int32 and got.shape == data.shape
    jd, jt = jnp.asarray(data), jnp.asarray(table)
    for ref in (lut_gather_lane(jd, jt, interpret=True),
                lut_gather_pallas(jd, jt, interpret=True), bj._lut_gather(jd, jt)):
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_lut_gather_groups_twin_matches_pallas():
    """One call of the grouped wrapper on the CPU (its twin, one twin call)
    over groups of both dtypes, each with its own table, among them a group
    of 0 elements, one of one element and a view one element into its
    buffer, against both Pallas kernels (interpret mode), group by group."""
    rng = np.random.default_rng(3)
    tables = np.stack([_table(seed) for seed in range(4)])
    u8 = rng.integers(0, 256, (3, 300)).astype(np.uint8)
    u8[0, :256] = np.arange(256)
    i32 = torch.from_numpy(rng.integers(0, 256, 513).astype(np.int32))
    groups = [(torch.from_numpy(u8), 2), (i32[1:], 0), (torch.zeros(0, dtype=torch.uint8), 1),
              (torch.tensor([255], dtype=torch.int32), 3), (torch.from_numpy(u8[2]), 0)]
    dispatch.reset_counts()
    got = lut.lut_gather_groups(groups, torch.from_numpy(tables))
    assert dispatch.TWIN_CALLS["lut_gather"] == 1 and not any(dispatch.LAUNCHES.values())
    assert len(got) == len(groups)
    for (data, k), out in zip(groups, got):
        assert out.dtype == torch.int32 and out.shape == data.shape
        if not data.numel():
            continue
        jd, jt = jnp.asarray(data.numpy()), jnp.asarray(tables[k])
        for ref in (lut_gather_lane(jd, jt, interpret=True),
                    lut_gather_pallas(jd, jt, interpret=True)):
            assert np.array_equal(out.numpy(), np.asarray(ref))


def test_lut_gather_rejects_what_the_kernel_does_not_take():
    table = torch.from_numpy(_table())
    with pytest.raises(TypeError):
        lut.lut_gather(torch.zeros(4, dtype=torch.int64), table)
    with pytest.raises(ValueError):
        lut.lut_gather(torch.zeros(4, dtype=torch.uint8), table[:128])
    with pytest.raises(TypeError):
        lut.lut_gather(torch.zeros(4, dtype=torch.uint8), table.long())
    tables = table[None].contiguous()
    with pytest.raises(ValueError):
        lut.lut_gather_groups([(torch.zeros(4, dtype=torch.uint8), 1)], tables)
    with pytest.raises(TypeError):
        lut.lut_gather_groups([(torch.zeros(4, dtype=torch.int16), 0)], tables)
    with pytest.raises(ValueError):
        lut.lut_gather_groups([(torch.zeros(4, dtype=torch.uint8), 0)], table)


def _emissions(kind, n_rows=9, m=300, seed=2):
    """(v, n) planes: random widths 0-32 with values of those widths (32-bit
    emissions straddle words), all zero widths, or all 32-bit."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = rng.integers(0, 33, (n_rows, m))
        n[:, ::7] = 0
        n[1] = 32
    elif kind == "zero":
        n = np.zeros((n_rows, m), np.int64)
    else:
        n = np.full((n_rows, m), 32, np.int64)
        n[2, 5] = 3                       # every later 32-bit emission straddles
    v = rng.integers(0, 1 << 32, (n_rows, m), dtype=np.uint64)
    v &= (np.uint64(1) << n.astype(np.uint64)) - np.uint64(1)
    v[n == 32] = rng.integers(0, 1 << 32, int((n == 32).sum()), dtype=np.uint64)
    return v.astype(np.uint32), n.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "zero", "wide"])
def test_pack_words_twin_matches_pallas(kind):
    """Whole (N, M+1) word arrays, zeros past each row's last bit, against
    pack_words_pallas (interpret mode) and the XLA pack_words."""
    v, n = _emissions(kind)
    dispatch.reset_counts()
    got = lut.pack_words(torch.from_numpy(v.view(np.int32)), torch.from_numpy(n))
    assert dispatch.TWIN_CALLS["pack_words"] == 1 and not any(dispatch.LAUNCHES.values())
    got = got.numpy().view(np.uint32)
    assert got.shape == (v.shape[0], v.shape[1] + 1)
    jv, jn = jnp.asarray(v), jnp.asarray(n)
    for ref in (pack_words_pallas(jv.astype(jnp.int32), jn, interpret=True),
                bj.pack_words(jv, jn)):
        assert np.array_equal(got, np.asarray(ref))


def test_pack_words_without_slots():
    words = lut.pack_words(torch.zeros((3, 0), dtype=torch.int32),
                           torch.zeros((3, 0), dtype=torch.int32))
    assert words.shape == (3, 1) and not words.any()


def test_fused_ok_matches_reference():
    for width in (0, 512, 600, 1536, 2304, 8192, 8704, 9216, 61440):
        assert emit.fused_ok(width) == jax_fused_ok(width, any_backend=True), width


@pytest.mark.parametrize("run_on", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("width", [600, 8704])
def test_emission_step_matches_reference(width, run_on):
    """The port's qv_encode_step at widths that fused_ok refuses, against the
    JAX package's (whose CPU path is its XLA emissions + pack_words); the
    route taken shows in the twin counts: one grouped lookup (K9's twin) for
    every lookup of the bucket."""
    args, _ = ge._example_batch(n_entries=8, length=width)
    ref = [np.asarray(x) for x in jax_step(*args, run_on=run_on)[:7]]
    dispatch.reset_counts()
    got = [x.numpy() for x in tp.qv_encode_step(*args, run_on=run_on)]
    n_run = sum(run_on)
    assert dispatch.TWIN_CALLS["encode_plain"] == dispatch.TWIN_CALLS["encode_run"] == 0
    assert dispatch.TWIN_CALLS["lut_gather"] == 1
    assert dispatch.TWIN_CALLS["pack_words"] == 1 + (n_run > 0)
    assert dispatch.TWIN_CALLS["pack_tags"] == 1
    assert got[0].shape == ref[0].shape
    assert np.array_equal(got[0].view(np.uint32), ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert np.array_equal(a, b)


def test_fused_step_takes_k1_k2():
    args, _ = ge._example_batch(n_entries=8, length=512)
    dispatch.reset_counts()
    tp.qv_encode_step(*args)
    assert dispatch.TWIN_CALLS["encode_plain"] == dispatch.TWIN_CALLS["encode_run"] == 1
    assert dispatch.TWIN_CALLS["lut_gather"] == dispatch.TWIN_CALLS["pack_words"] == 0


def test_long_read_file_routes_like_reference(monkeypatch):
    """A corpus with reads over 8,192 symbols: every bucket's rectangle is as
    wide as the JAX package's file path makes it (its rows padded by
    pad_rows(align=512, bucket=True), and at least the bucket width), takes
    the route fused_ok gives that width, and the file's bytes equal the JAX
    package's and the native encoder's."""
    lengths = [9000, 300, 12000, 2049, 8192, 0, 1536]
    data = make_quiva(np.random.default_rng(5), lengths=lengths)
    widths = []
    step = tq.qv_encode_step

    def spy(streams, *a, **kw):
        widths.append(streams.shape[2])
        return step(streams, *a, **kw)

    monkeypatch.setattr(tq, "qv_encode_step", spy)
    dispatch.reset_counts()
    got = tq.encode_quiva_to_dexqv(data, device="cpu")
    assert got == jax_encode(data, device=False)
    assert got == tq.encode_quiva_to_dexqv(data, device=False)
    kb = np.array([jax_bucket_len(max(x, 1), 512) for x in lengths])
    want = []
    for w in np.unique(kb):
        lens = np.array(lengths)[kb == w]
        rows = jax_pad_rows(np.zeros(int(lens.sum()), np.uint8), lens, align=512,
                            bucket=True)
        want.append(max(rows.shape[1], int(w)))
    assert widths == want
    fused = [w for w in widths if emit.fused_ok(w)]
    assert fused and len(fused) < len(widths)
    assert dispatch.TWIN_CALLS["encode_plain"] == len(fused)
    assert dispatch.TWIN_CALLS["pack_words"] == 2 * (len(widths) - len(fused))
