"""The port's sharded pipeline against the JAX package's: the scan steps and
the sharded scan with its delChar election and subChar prefix, the sharded
encode on both routes, the sharded 2-bit codec, the sharded segmented
decode, the ``mesh=`` of ``decode_dexqv_to_quiva`` and ``load_all_qventries``, the
multi-process helpers and a two-process gloo run of tools/multichip.py.
The JAX side shards over ``make_mesh(8)`` (the eight virtual CPU devices of
tests/conftest.py), the port over ``make_mesh(8, "cpu")``, whose shards run
the kernels' plain twins.  Integer codec: every comparison is exact."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_bam

from dextractor_tpu.codecs import qv_codec as jqc
from dextractor_tpu.parallel import make_mesh as jax_mesh
from dextractor_tpu.parallel import multihost as jmh
from dextractor_tpu.parallel import pipeline as jpl

from dextractor_tpu_torch.cli.dex2DB import main as dex2db
from dextractor_tpu_torch.codecs import qv_batch as tqb
from dextractor_tpu_torch.codecs import qv_codec as tqc
from dextractor_tpu_torch.db import open_db
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.formats.quiva import parse_quiva
from dextractor_tpu_torch.formats.ragged import pad_rows
from dextractor_tpu_torch.ops import decode2 as td2
from dextractor_tpu_torch.ops import twobit as tb
from dextractor_tpu_torch.parallel import make_mesh
from dextractor_tpu_torch.parallel import mesh as tmesh
from dextractor_tpu_torch.parallel import multihost as tmh
from dextractor_tpu_torch.parallel import pipeline as tpl
from dextractor_tpu_torch.testing import make_quiva
from dextractor_tpu_torch.tools.multichip import step_outputs_equal
from dextractor_tpu_torch.utils import dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("del_hist", "ins_hist", "mrg_hist", "sub_hist", "del_run", "sub_run",
         "del_char", "sub_char", "tot_char")


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_mesh(8, "cpu")


def _rect(quiva, width=None, n_pad=None):
    """(parsed, streams (5, N, L) u8, lengths (N,) i32), the rows padded to
    512 symbols or to ``width``, the reads to ``n_pad`` with empty reads."""
    q = parse_quiva(quiva)
    lengths = q.lengths.astype(np.int64)
    streams = np.stack([pad_rows(q.streams[s], lengths, align=width or 512, bucket=not width)
                        for s in range(5)])
    if n_pad:
        streams = np.pad(streams, ((0, 0), (0, n_pad - q.n_entries), (0, 0)))
        lengths = np.pad(lengths, (0, n_pad - q.n_entries))
    return q, streams, lengths.astype(np.int32)


def _late_n():
    """16 reads whose first 'n' delTag is in read 10 (shard 5 of 8): ten
    reads without a delQV run character, then six with one."""
    head = make_quiva(np.random.default_rng(3), n_reads=10, min_len=50, max_len=300,
                      del_run=False)
    return head + make_quiva(np.random.default_rng(4), n_reads=6, min_len=50, max_len=300)


SCAN_CASES = {
    "n24": lambda: make_quiva(np.random.default_rng(1), n_reads=24, min_len=1, max_len=400),
    "n13": lambda: make_quiva(np.random.default_rng(9), n_reads=13, min_len=200, max_len=600),
    "late_n": _late_n,
    # over 100,000 symbols: subChar from the prefix, and a run-coded subQV
    "sub_100k": lambda: make_quiva(np.random.default_rng(7), n_reads=52, min_len=1800,
                                   max_len=2200, sub_heavy=True),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_sharded_scan_matches_reference(meshes, case):
    """sharded_qv_scan's tables and election and sharded_scan_to_stats'
    QVStats equal the JAX package's and the host scan's."""
    jmesh, mesh = meshes
    q, streams, lengths = _rect(SCAN_CASES[case]())
    n = q.n_entries
    n8 = -(-n // 8) * 8
    _, jstreams, jlengths = _rect(SCAN_CASES[case](), n_pad=n8)
    got = tpl.sharded_qv_scan(mesh)(streams, lengths)
    ref = jpl.sharded_qv_scan(jmesh)(jnp.asarray(jstreams), jnp.asarray(jlengths))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if case == "late_n":
        assert int(got[2]) == 5 and int(got[3]) == 0
    stats = tpl.sharded_scan_to_stats(mesh, streams, lengths)
    jstats = jpl.sharded_scan_to_stats(jmesh, jnp.asarray(streams), jnp.asarray(lengths))
    host = tqc.scan_quiva(q)
    for f in STATS:
        assert np.array_equal(getattr(stats, f), getattr(jstats, f)), f
        assert np.array_equal(getattr(stats, f), getattr(host, f)), f
    assert (stats.sub_char >= 0) == (case == "sub_100k")


def test_scan_steps_match_reference():
    """qv_scan_step, qv_run_hist_step and qv_subchar_prefix_step of one
    shard against the JAX package's, with rows past their lengths full of
    the run character and of 'n' tags."""
    q, streams, lengths = _rect(make_quiva(np.random.default_rng(2), n_reads=9,
                                           min_len=0, max_len=700))
    streams[0][streams[0] == 0] = ord("f")
    streams[1][streams[1] == 0] = ord("n")
    t = torch.from_numpy(streams), torch.from_numpy(lengths)
    for a, b in zip(tpl.qv_scan_step(*t), jpl.qv_scan_step(jnp.asarray(streams),
                                                           jnp.asarray(lengths))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for rchar in (ord("f"), 0, 255):
        got = tpl.qv_run_hist_step(t[0][0], t[1], rchar)
        ref = jpl.qv_run_hist_step(jnp.asarray(streams[0]), jnp.asarray(lengths),
                                   jnp.int32(rchar))
        assert np.array_equal(got.numpy(), np.asarray(ref))
    for upto in (0, 4, 8):
        got = tpl.qv_subchar_prefix_step(t[0][4], t[1], upto)
        ref = jpl.qv_subchar_prefix_step(jnp.asarray(streams[4]), jnp.asarray(lengths),
                                         jnp.int32(upto))
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("width", [512, 600])
def test_sharded_encode_matches_reference(meshes, width):
    """sharded_qv_encode over 13 reads (two a shard, one in the seventh,
    none in the eighth) equals qv_encode_step on one device, with run_on as
    the coding's flags and as the default, and the JAX package's first
    seven outputs (with the flags at 512, with the default at 600); width
    512 takes K1/K2, 600 the emission route (K9/K8).  The assembled
    container equals the native encoder's bytes."""
    jmesh, mesh = meshes
    quiva = make_quiva(np.random.default_rng(21), n_reads=13, min_len=200, max_len=500)
    q, streams, lengths = _rect(quiva, width)
    _, jstreams, jlengths = _rect(quiva, width, n_pad=16)
    coding = tqc.create_qvcoding(tqc.scan_quiva(q), q.prefix, False)
    sym, run, rchars, nlut, flags = tqc.step_tables(coding)
    tables = (sym, run, rchars, nlut)
    native = tqc.encode_quiva_to_dexqv(quiva, device=False)
    for run_on in (flags, (True, True)):
        dispatch.reset_counts()
        got = tpl.sharded_qv_encode(mesh, run_on)(streams, lengths, *tables)
        assert dispatch.TWIN_CALLS["lut_gather" if width == 600 else "encode_plain"] == 8
        assert step_outputs_equal(got, tpl.qv_encode_step(streams, lengths, *tables,
                                                          run_on=run_on))
        assert tqc.assemble_from_step(got, coding, q.wells, q.begs, q.ends, q.qvs,
                                      q.n_entries) == native
        if (run_on == flags) != (width == 512):
            continue          # one JAX comparison a width: the flags at 512, the default at 600
        ref = jpl.sharded_qv_encode(jmesh, run_on)(
            *(jnp.asarray(x) for x in (jstreams, jlengths, *tables)))
        words, raw = got[0].numpy().view(np.uint32), got[1].numpy()
        for i, (a, b) in enumerate(zip(got[1:], ref[1:7])):
            assert np.array_equal(a.numpy(), np.asarray(b)[:, :13] if i < 4
                                  else np.asarray(b)[:13]), i
        jwords = np.asarray(ref[0])
        assert words.shape[2] == jwords.shape[2]
        for c in range(4):
            for i in range(13):
                assert np.array_equal(words[c, i, :raw[c, i]], jwords[c, i, :raw[c, i]])


@pytest.fixture(scope="module")
def long_encoded():
    """Long-read mixes of 0-3,000 symbols, delQV run-coded and plain: an
    empty read, reads of one and two segments of 2,048, five reads on
    eight shards."""
    out = {}
    for name, kw in (("run_del", {}), ("plain_del", dict(del_run=False))):
        data = make_quiva(np.random.default_rng(43), lengths=[3000, 0, 2100, 150, 33], **kw)
        out[name] = (data, tqc.encode_quiva_to_dexqv(data, device=False))
    return out


ROUTES = {"segmented": {}, "per_read": {"DXT_SEG_DECODE": "0"}}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", ["run_del", "plain_del"])
def test_sharded_decode_matches_original(meshes, long_encoded, name, route, monkeypatch):
    """decode_dexqv_to_quiva(mesh=make_mesh(8, "cpu")) on every route gives
    the original bytes; on the default route, the JAX package's sharded
    decode's too."""
    jmesh, mesh = meshes
    data, enc = long_encoded[name]
    calls = []
    for fn in ("sharded_decode_entry", "sharded_decode_entry_seg"):
        def spy(mesh_, *a, _fn=fn, _orig=getattr(tpl, fn), **kw):
            calls.append((_fn, mesh_))
            return _orig(mesh_, *a, **kw)
        monkeypatch.setattr(tqb, fn, spy)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    assert tqc.decode_dexqv_to_quiva(enc, mesh=mesh) == data
    assert {c[0] for c in calls} == {"sharded_decode_entry" if route == "per_read"
                                     else "sharded_decode_entry_seg"}
    assert all(c[1] is mesh for c in calls)
    if route == "segmented" and name == "run_del":
        assert jqc.decode_dexqv_to_quiva(enc, device=True, mesh=jmesh) == data


def test_decode_device_must_agree_with_mesh():
    mesh = make_mesh(2, "cpu")
    data = make_quiva(np.random.default_rng(5), n_reads=3, max_len=100)
    enc = tqc.encode_quiva_to_dexqv(data, device=False)
    with pytest.raises(ValueError):
        tqc.decode_dexqv_to_quiva(enc, device=False, mesh=mesh)
    with pytest.raises(ValueError):
        tqc.decode_dexqv_to_quiva(enc, device="meta", mesh=mesh)
    with pytest.raises(ValueError):
        tmesh.check_device(tmesh.Mesh(mesh.devices, (0,)), None)
    assert tqc.decode_dexqv_to_quiva(enc, device="cpu", mesh=mesh) == data


def _seg_args(enc):
    """The flat segmented launch of ``enc`` at segments of 256 symbols
    (qv_batch.build_seg_launch_flat) and its decode tables."""
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    idx = tqc._index_native(enc, coding, off, True)
    ck = tqc._index_checkpoints(enc, coding, off, True, idx[5], seg=256)
    _, _, _, _, eoffs, elens, coffs, ntoks = idx
    args, statics, _, _ = tqb.build_seg_launch_flat(
        np.frombuffer(enc, np.uint8), eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck)
    sids, f1, f2, types, _, _, subw, lmax = tqb.decode_tables_v2(coding)
    chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))
    tables = (sids, torch.from_numpy(f1), torch.from_numpy(f2), types,
              coding.del_char & 0xFF, coding.sub_char & 0xFF)
    return args, dict(statics, subw=subw, lmax=lmax, chan_l2=chan_l2), tables


@pytest.mark.parametrize("shards", [1, 7, 8])
@pytest.mark.parametrize("name", ["run_del", "plain_del"])
def test_sharded_seg_decode_matches_one_device(long_encoded, name, shards):
    """sharded_decode_entry_seg over 1, 7 (no divisor of the 24 segment
    rows: the last shard holds only padding) and 8 shards equals
    decode_entry_batch_seg on all segment rows at once, row for row."""
    args, kw, tables = _seg_args(long_encoded[name][1])
    assert len(args[5]) == 24
    t = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args]
    want = td2.decode_entry_batch_seg(*t, *tables, **kw)
    got = tpl.sharded_decode_entry_seg(make_mesh(shards, "cpu"), **kw)(*args, *tables)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def two_cell_db(tmp_path_factory):
    """A DB of two cells (two codings) whose qvchk track holds checkpoints
    every 256 symbols, so that reads of 257-400 symbols decode as two
    segments on the fused route."""
    d = tmp_path_factory.mktemp("pdb")
    rng = np.random.default_rng(15)
    for k, (n, lo, hi) in enumerate(((3, 50, 300), (1, 257, 400))):
        (d / f"m{k}.subreads.bam").write_bytes(make_bam(rng, n_reads=n, min_len=lo,
                                                        max_len=hi, movie=b"m%d" % k)[0])
    old = os.getcwd()
    os.chdir(d)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tqc, "SEG_DECODE", 256)
            assert dex2db(["-q", "-eln>=0", "DB", "m0.subreads.bam", "m1.subreads.bam"]) == 0
    finally:
        os.chdir(old)
    return str(d / "DB.db")


@pytest.mark.parametrize("route", ["fused", "scheme"])
def test_db_load_sharded_matches(meshes, two_cell_db, route, monkeypatch):
    """load_all_qventries(mesh=...) equals the call without a mesh on the
    fused (segmented) route and the per-scheme route."""
    monkeypatch.setenv("DXT_DB_FUSED", "1" if route == "fused" else "0")
    db = open_db(two_cell_db)
    db.open_qvs()
    assert len(db._qv.codings) == 2
    single, lengths = db.load_all_qventries(1, device="cpu")
    segs = []
    monkeypatch.setattr(tqb, "sharded_decode_entry_seg",
                        lambda *a, _f=tqb.sharded_decode_entry_seg, **kw:
                        segs.append(kw["seg"]) or _f(*a, **kw))
    sharded, l2 = db.load_all_qventries(1, mesh=meshes[1])
    assert np.array_equal(single, sharded) and np.array_equal(lengths, l2)
    assert segs == ([256, 256] if route == "fused" else [])


@pytest.mark.parametrize("alphabet", ["base", "arrow"])
def test_sharded_twobit_matches_reference(meshes, alphabet):
    """sharded_twobit_encode/decode over 13 ragged rows of 90 letters
    (no multiple of 4) equal the JAX package's on rows padded to 92."""
    jmesh, mesh = meshes
    rng = np.random.default_rng(17)
    lens = rng.integers(0, 91, 13)
    letters = np.frombuffer(b"acgtACGTNn" if alphabet == "base" else b"1234G5", np.uint8)
    rows = letters[rng.integers(0, len(letters), (13, 90))]
    got = tpl.sharded_twobit_encode(mesh, alphabet)(rows, lens, tb.NUMBER_BASE_LUT)
    ref = np.asarray(jpl.sharded_twobit_encode(jmesh, alphabet)(
        jnp.asarray(np.pad(rows, ((0, 3), (0, 2)))), jnp.asarray(np.pad(lens, (0, 3))),
        jnp.asarray(tb.NUMBER_BASE_LUT)))[:13]
    assert np.array_equal(got.numpy(), ref)
    out = tpl.sharded_twobit_decode(mesh)(got, tb.UPPER_LUT)
    jout = np.asarray(jpl.sharded_twobit_decode(jmesh)(
        jnp.asarray(np.pad(ref, ((0, 3), (0, 0)))), jnp.asarray(tb.UPPER_LUT)))[:13]
    assert np.array_equal(out.numpy(), jout)
    # a given table, with a code-0 byte and without one
    for nlut in (tb.NUMBER_ARROW_LUT, (tb.NUMBER_BASE_LUT % 3) + 1):
        generic = tpl.sharded_twobit_encode(mesh, None)(rows, lens, nlut)
        jgeneric = np.asarray(jpl.sharded_twobit_encode(jmesh, None)(
            jnp.asarray(np.pad(rows, ((0, 3), (0, 2)))), jnp.asarray(np.pad(lens, (0, 3))),
            jnp.asarray(nlut)))[:13]
        assert np.array_equal(generic.numpy(), jgeneric)


def test_multihost_helpers_match_reference():
    parts = [(np.array([1, 2, 3], np.uint8), np.array([2, 1], np.int64)),
             (np.array([4, 5], np.uint8), np.array([2], np.int64)), ]
    for a, b in zip(tmh.ordered_gather(parts), jmh.ordered_gather(parts)):
        assert np.array_equal(a, b)
    for a, b in zip(tmh.ordered_gather([]), jmh.ordered_gather([])):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    for total, num in ((100, 3), (7, 8), (0, 2), (16, 4)):
        for pid in range(num):
            assert tmh.process_read_range(total, pid, num) == \
                jmh.process_read_range(total, pid, num)
    assert tmh.process_read_range(10) == (0, 10)
    mesh = make_mesh(3, "cpu")
    per, blocks = mesh.split(7)
    assert per == 3 and blocks == [(0, 0, 3), (1, 3, 6), (2, 6, 7)]
    put = tmh.mesh_put(mesh)(np.arange(14).reshape(7, 2), 0)
    assert [b.tolist() for b in put][2] == [[12, 13], [0, 0], [0, 0]]
    assert tmesh.all_reduce(mesh, [torch.tensor([1, 5]), torch.tensor([3, 2]),
                                   torch.tensor([2, 4])], "max").tolist() == [3, 5]
    assert not tmh.initialize(num_processes=1)
    if not torch.distributed.is_backend_available("nccl"):
        with pytest.raises(RuntimeError):     # the cards' backend, absent here
            tmh.initialize("127.0.0.1:1", 2, 0, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_encode(tmp_path):
    """Two ranks of tools/multichip.py over gloo: the scan's tables summed
    across the processes, each rank's block encoded and framed; the parts
    concatenated are the native encoder's file."""
    quiva = make_quiva(np.random.default_rng(13), n_reads=15, min_len=100, max_len=400)
    src = tmp_path / "g.quiva"
    src.write_bytes(quiva)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dextractor_tpu_torch.tools.multichip", "--rank", str(r),
         "--world", "2", "--coordinator", coordinator, "--quiva", str(src), "--out",
         str(tmp_path), "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
        assert b'"backend": "gloo"' in out
    parts = (tmp_path / "part0.bin").read_bytes() + (tmp_path / "part1.bin").read_bytes()
    assert parts == tqc.encode_quiva_to_dexqv(quiva, device=False)
