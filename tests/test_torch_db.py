"""The port's Dazzler DB family against the JAX package's: dex2DB's files
byte for byte, the DB library's loaders, tracks and block arguments, and
``DazzDB.load_all_qventries`` on every route (the fused route with the
``qvchk`` track and on the native lens walk, and the per-scheme route) in
every ascii mode, on DBs of two codings.  On the CPU the QV load runs the
decode kernels' plain twins (``device="cpu"``)."""

import os
import shutil

import numpy as np
import pytest
import torch

from conftest import make_bam
from test_bax import make_bax_file

import dextractor_tpu.db as jdb
from dextractor_tpu.cli.dex2DB import main as jax_dex2db
from dextractor_tpu.db import qvtrack as jqvtrack
from dextractor_tpu.db import tracks as jtracks
from dextractor_tpu.db.build import split_db as jax_split_db

import dextractor_tpu_torch.db as tdb
from dextractor_tpu_torch.cli.dex2DB import main as dex2db
from dextractor_tpu_torch.codecs import qv_batch
from dextractor_tpu_torch.db import qvtrack as tqvtrack
from dextractor_tpu_torch.db import tracks as ttracks
from dextractor_tpu_torch.db.build import split_db
from dextractor_tpu_torch.native import hdf5_shim
from dextractor_tpu_torch.testing import make_bam as make_bam_lengths
from dextractor_tpu_torch.utils import dispatch

PKGS = {"jax": (jax_dex2db, jax_split_db), "port": (dex2db, split_db)}


def _inputs(d):
    """The BAM cells of the cases (and a .bax.h5 where libhdf5 loads)."""
    rng = np.random.default_rng(31)
    bams = {"a": make_bam(rng, n_reads=8, min_len=300, max_len=900),
            "b": make_bam(rng, n_reads=5, min_len=100, max_len=700, movie=b"m_b"),
            "c": make_bam(rng, n_reads=6, min_len=20, max_len=300, movie=b"m_c"),
            "long": make_bam_lengths(rng, lengths=[2100, 300], movie=b"m_long")}
    for name, (bam, _) in bams.items():
        (d / f"{name}.subreads.bam").write_bytes(bam)
    try:
        hdf5_shim()
    except OSError:
        return
    make_bax_file(str(d / "x.bax.h5"), np.random.default_rng(33))


def _run(pkg, steps, d):
    """Run dex2DB steps (argument lists) and ("split", bsize) in ``d``;
    returns the exit codes."""
    main, split = PKGS[pkg]
    old = os.getcwd()
    os.chdir(d)
    try:
        return [split("DB.db", step[1]) if step[0] == "split" else main(step)
                for step in steps]
    finally:
        os.chdir(old)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file() and not p.name.endswith((".bam", ".h5"))}


E = "-eln>=0"
CASES = {
    "sequence": [[E, "DB", "a.subreads.bam"]],
    "quiva": [["-q", E, "DB", "a.subreads.bam"]],
    "arrow": [["-a", "-v", E, "DB", "a.subreads.bam", "b.subreads.bam"]],
    "lossy_default_filter": [["-q", "-l", "DB", "a.subreads.bam", "b.subreads.bam"]],
    "two_cells_long": [["-q", E, "DB", "a.subreads.bam", "long.subreads.bam"]],
    "append": [["-q", E, "DB", "b.subreads.bam"], ["-q", E, "DB", "long.subreads.bam"]],
    "split_append": [[E, "DB", "a.subreads.bam"], ("split", 2000),
                     [E, "DB", "b.subreads.bam"]],
    "type_and_duplicate_errors": [["-q", E, "DB", "a.subreads.bam"],
                                  ["-a", E, "DB", "b.subreads.bam"],
                                  ["-q", E, "DB", "b.subreads.bam", "a.subreads.bam"]],
    "bax": [["-q", E, "DB", "x.bax.h5"], ["-q", E, "DB", "b.subreads.bam"]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_dex2db_matches_reference(tmp_path, case):
    """The port's dex2DB writes the same stub, .idx, .bps, .qvs, .arw and
    qvchk track files as the JAX package's, and fails the same way (a
    failed append rolls back to the same bytes)."""
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        _inputs(d)
        if case == "bax" and not (d / "x.bax.h5").exists():
            pytest.skip("libhdf5 unavailable")
        out[pkg] = (_run(pkg, CASES[case], d), _files(d))
    assert out["port"] == out["jax"]
    rcs, files = out["port"]
    assert rcs[0] == 0 and "DB.db" in files
    if "-q" in CASES[case][0]:
        assert ".DB.qvchk.anno" in files and ".DB.qvchk.data" in files


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Two-cell QV DBs built by the JAX package: "short" (cells c, b),
    "long" (cells c, long: reads over SEG_DECODE) and "walk" (short without
    its qvchk track)."""
    d = tmp_path_factory.mktemp("dbs")
    _inputs(d)
    old = os.getcwd()
    os.chdir(d)
    try:
        assert jax_dex2db(["-q", E, "SHORT", "c.subreads.bam", "b.subreads.bam"]) == 0
        assert jax_dex2db(["-q", E, "LONG", "c.subreads.bam", "long.subreads.bam"]) == 0
    finally:
        os.chdir(old)
    w = d / "walk"
    w.mkdir()
    for f in ("SHORT.db", ".SHORT.idx", ".SHORT.bps", ".SHORT.qvs"):
        shutil.copy(d / f, w / f)
    return {"short": str(d / "SHORT.db"), "long": str(d / "LONG.db"),
            "walk": str(w / "SHORT.db")}


def _open(pkg, path):
    db = pkg.open_db(path)
    db.open_qvs()
    return db


@pytest.fixture(scope="module")
def per_read():
    """(path, mode) -> the JAX package's per-read loader over the whole DB,
    concatenated, each computed once."""
    cache = {}

    def get(path, mode):
        if (path, mode) not in cache:
            db = _open(jdb, path)
            cache[path, mode] = np.concatenate(
                [db.load_qventry(i, mode) for i in range(db.nreads)], 1)
        return cache[path, mode]
    return get


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("route", ["fused", "walk", "scheme"])
def test_load_all_qventries_matches_per_read(dbs, per_read, monkeypatch, route, mode):
    """The port's QV load of a two-coding DB, on the CPU, equals the JAX
    package's per-read loader (load_qventry, on the host) concatenated."""
    monkeypatch.setenv("DXT_DB_FUSED", "0" if route == "scheme" else "1")
    db = _open(tdb, dbs["walk" if route == "walk" else "short"])
    assert len(db._qv.codings) == 2
    assert (tqvtrack.load_qvchk(db) is None) == (route == "walk")
    dispatch.reset_counts()
    streams, lengths = db.load_all_qventries(mode, device="cpu")
    np.testing.assert_array_equal(streams, per_read(dbs["short"], mode))
    np.testing.assert_array_equal(lengths, db.reads["rlen"])
    # the fused route: a launch set a cell and span bucket (K4 on ins, mrg
    # and sub at once); the per-scheme route: a launch a channel, coding and
    # rectangle width
    calls = dispatch.TWIN_CALLS
    assert calls["decode_run"] == calls["expand_runs"] >= 2
    if route == "scheme":
        assert calls["decode_plain"] >= 3 * 2
    else:
        assert calls["decode_plain"] == calls["decode_run"]


@pytest.mark.parametrize("route,mode", [("fused", 1), ("scheme", 0)])
def test_load_all_qventries_long_matches_reference(dbs, monkeypatch, route, mode):
    """Reads over SEG_DECODE: the fused route decodes them segmented from the
    qvchk track's checkpoints; both routes equal the JAX package's
    load_all_qventries on its CPU (its XLA chains), byte for byte."""
    monkeypatch.setenv("DXT_DB_FUSED", "0" if route == "scheme" else "1")
    seg = []
    orig = qv_batch.fused_decode_entries_seg
    monkeypatch.setattr(qv_batch, "fused_decode_entries_seg",
                        lambda *a, **k: seg.append(1) or orig(*a, **k))
    got, lengths = _open(tdb, dbs["long"]).load_all_qventries(mode, device="cpu")
    want, wlen = _open(jdb, dbs["long"]).load_all_qventries(mode)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lengths, wlen)
    assert bool(seg) == (route == "fused")


def test_index_cell_matches_reference(dbs):
    """The headerless native lens walk of each cell (the fused route's index
    when the track is gone) gives the JAX package's channel offsets, token
    counts and checkpoints, long reads included."""
    for path in (dbs["short"], dbs["long"]):
        db = _open(tdb, path)
        starts = db.reads["coff"].astype(np.int64)
        rlens = db.reads["rlen"].astype(np.int64)
        for ci, sl in tqvtrack._cell_groups(db._qv, db.nreads):
            coding = db._qv.codings[ci]
            got = tqvtrack.index_cell(db._qv.data, coding, starts[sl], rlens[sl], 2048)
            jdbo = _open(jdb, path)
            want = jqvtrack.index_cell(jdbo._qv.data, jdbo._qv.codings[ci], starts[sl],
                                       rlens[sl], 2048)
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g, w)
            assert (got[2] is None) == (want[2] is None) == (rlens[sl].max() <= 2048)
            if got[2] is not None:
                assert got[2][0] == want[2][0]
                for g, w in zip(got[2][1:], want[2][1:]):
                    np.testing.assert_array_equal(g, w)


def test_load_all_qventries_device_argument(dbs, per_read, monkeypatch):
    """``device`` follows utils/dispatch.resolve_device: a CUDA request
    without CUDA raises; the host path (False, or DXT_DEVICE=0) runs the
    twins on the CPU, with the bytes of device="cpu"."""
    db = _open(tdb, dbs["short"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        db.load_all_qventries(1, device=True)
    dispatch.reset_counts()
    np.testing.assert_array_equal(db.load_all_qventries(1, device=False)[0],
                                  per_read(dbs["short"], 1))
    twins = dict(dispatch.TWIN_CALLS)
    assert twins["decode_plain"] > 0
    monkeypatch.setenv("DXT_DEVICE", "0")
    np.testing.assert_array_equal(db.load_all_qventries(1)[0], per_read(dbs["short"], 1))
    assert dispatch.TWIN_CALLS["decode_plain"] == 2 * twins["decode_plain"]


def _db_view(pkg, path, block=None):
    """What the DB library's loaders give on one DB (or one block part)."""
    db = pkg.open_db(path if block is None else path.replace("DB.db", f"DB.{block}.db"))
    out = {"reads": db.reads.tobytes(), "header": db.header.tobytes(),
           "nreads": db.nreads, "sizeof": db.sizeof(), "part": db.part,
           "first": (db.ufirst, db.tfirst)}
    for i in range(db.nreads):
        out[f"read {i}"] = [db.load_read(i, m) for m in (0, 1, 2)]
        rl = int(db.reads["rlen"][i])
        out[f"sub {i}"] = [db.load_subread(i, b, e, 2)
                           for b, e in ((0, rl), (3, max(rl - 5, 3)), (rl // 2, rl))]
    out["all"] = db.load_all_reads()
    if db.is_arrow:
        db.open_arrow()
        out["arrows"] = [db.load_all_arrows(m) for m in (False, True)]
        out["arrow 0"] = [db.load_arrow(0, m) for m in (False, True)]
        out["snrs"] = db.snrs()
    db.trim()
    out["trimmed"] = db.reads.tobytes()
    out["files"] = [os.path.basename(f) for f in pkg.list_db_files(path)]
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, (list, tuple)):
            assert len(x) == len(y), k
            for u, v in zip(x, y):
                _same({k: u}, {k: v})
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


@pytest.mark.parametrize("case", ["sequence", "arrow", "split_append"])
def test_db_loaders_match_reference(tmp_path, case):
    """open_db (whole and block parts), trim, the read, subread, arrow and
    SNR loaders, sizeof and list_db_files give what the JAX package's give,
    on a DB built by the port."""
    _inputs(tmp_path)
    assert _run("port", CASES[case], tmp_path)[0] == 0
    path = str(tmp_path / "DB.db")
    _same(_db_view(tdb, path), _db_view(jdb, path))
    stub = tdb.read_stub(path)
    assert stub.__dict__ == jdb.read_stub(path).__dict__
    for block in range(1, (stub.nblocks if stub.partitioned else 0) + 1):
        _same(_db_view(tdb, path, block), _db_view(jdb, path, block))
        assert tdb.fetch_block_range(path, False, block) \
            == jdb.fetch_block_range(path, False, block)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("arg", ["/x/FOO.@3-5.db", "/x/FOO.db", "/x/FOO.@7.db", "FOO.@2",
                                 "/x/RUN.@1-10.las"])
def test_block_arguments_match_reference(arg):
    """Block_Looper's @-arguments expand alike (an open range with no DB to
    bound it fails alike)."""
    if arg.endswith(".las"):
        t, j = tdb.parse_block_las_arg(arg), jdb.parse_block_las_arg(arg)
        slices = [(t.next_slice(4), j.next_slice(4)) for _ in range(4)]
        assert all(a == b for a, b in slices) and slices[-1][0] is None
        return
    t, j = _outcome(tdb.parse_block_db_arg, arg), _outcome(jdb.parse_block_db_arg, arg)
    if isinstance(j, tuple):
        assert t == j
        return
    assert (t.first, t.last, t.arg_root()) == (j.first, j.last, j.arg_root())
    names = []
    while t.advance():
        assert j.advance()
        names.append(t.arg_root())
        assert names[-1] == j.arg_root()
    assert not j.advance()


def test_tracks_and_extras_match_reference(tmp_path):
    """A data track with extras and a fixed-size anno track: the port
    writes the JAX package's bytes and reads back what it reads; extras
    fold alike."""
    _inputs(tmp_path)
    _run("port", CASES["sequence"], tmp_path)
    db, jd = tdb.open_db(str(tmp_path / "DB.db")), jdb.open_db(str(tmp_path / "DB.db"))
    n = db.nreads
    anno = np.zeros(n + 1, np.int32)
    np.cumsum(np.arange(1, n + 1), out=anno[1:])
    data = np.arange(anno[-1], dtype=np.int64).astype(np.uint8)
    for mod, d, tag in ((ttracks, db, "t"), (jtracks, jd, "j")):
        extra = mod.Extra(mod.DB_INT, mod.DB_SUM, b"coverage", np.array([42], np.int64))
        mod.write_track(d.path, f"test{tag}",
                        mod.Track(name=f"test{tag}", size=4, nreads=n, anno=anno,
                                  data=data, extras=[extra]))
        mod.write_track(d.path, f"qual{tag}",
                        mod.Track(name=f"qual{tag}", size=2, nreads=n, data=None,
                                  anno=np.arange(2 * n, dtype=np.uint8).reshape(n, 2)))
    for kind in ("test", "qual"):
        for suf in ("anno", "data"):
            p, q = (tmp_path / f".DB.{kind}{t}.{suf}" for t in "tj")
            assert p.exists() == q.exists()
            if p.exists():
                assert p.read_bytes() == q.read_bytes()
        assert ttracks.check_track(db, f"{kind}j") == jtracks.check_track(jd, f"{kind}j")
        got, want = ttracks.open_track(db, f"{kind}j"), jtracks.open_track(jd, f"{kind}j")
        assert (got.nreads, got.size, got.data is None) == (want.nreads, want.size,
                                                             want.data is None)
        np.testing.assert_array_equal(got.anno, want.anno)
        if got.data is not None:
            np.testing.assert_array_equal(got.read_data(2), want.read_data(2))
            assert [(e.name, e.value.tolist()) for e in got.extras] \
                == [(e.name, e.value.tolist()) for e in want.extras]
    for mod in (ttracks, jtracks):
        e1 = mod.Extra(mod.DB_INT, mod.DB_SUM, b"c", np.array([10], np.int64))
        e1.fold(mod.Extra(mod.DB_INT, mod.DB_SUM, b"c", np.array([5], np.int64)))
        assert int(e1.value[0]) == 15
        e2 = mod.Extra(mod.DB_INT, mod.DB_EXACT, b"p", np.array([7], np.int64))
        with pytest.raises(Exception) as err:
            e2.fold(mod.Extra(mod.DB_INT, mod.DB_EXACT, b"p", np.array([8], np.int64)))
        assert type(err.value).__name__ == "FormatError"
