"""The port's ingest layer against the JAX package's: the -e filter DSL,
dextract from BAM, SAM and .bax.h5 inputs, the BAM writer of
``dextractor_tpu_torch.testing``, ``utils.numbers`` and the 2-bit pack with
read lengths.  All host code: no kernel runs here."""

import os
import shutil

import numpy as np
import pytest

from conftest import make_bam as conftest_make_bam
from test_bax import make_bax_file
from test_dextract import _bam_to_sam_text

from dextractor_tpu.cli.dextract import main as jax_dextract
from dextractor_tpu.ingest import filter as jfilter
from dextractor_tpu.ops import twobit as jtb
from dextractor_tpu.utils import numbers as jnumbers

from dextractor_tpu_torch import testing
from dextractor_tpu_torch.cli.dextract import main as dextract
from dextractor_tpu_torch.ingest import filter as tfilter
from dextractor_tpu_torch.ops import twobit as ttb
from dextractor_tpu_torch.utils import numbers as tnumbers

# the expressions of tests/test_filter.py, and a few more of the grammar
EXPRESSIONS = [
    jfilter.DEFAULT_FILTER,
    "zm==1 || zm==2 && ln>10",
    "(zm==1 || zm==2) && ln>10",
    "ln<5 || ln<=6 || ln>100 || ln>=90 || ln!=50 || ln==42",
    "bc1==0",
    "bc1<0",
    "1==1 && ln>0",
    "bq>=50 && np<10 || qs>20 && bc2!=3",
    "((rq>500))",
    # syntax errors, one of each kind
    "xy>=5",
    "ln 5",
    "(ln>5",
    "ln>5 & rq>6",
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_filter_matches_reference(expr):
    """Parse and evaluate (or fail with the same message) as the JAX
    package's filter, on seeded fields with some variables left undefined."""
    rng = np.random.default_rng(len(expr))
    fields = {v: rng.integers(-2, 1200, 64) for v in tfilter.VARS[:5]}
    try:
        want = jfilter.parse_filter(expr).evaluate(fields)
    except jfilter.FilterError as e:
        with pytest.raises(tfilter.FilterError) as got:
            tfilter.parse_filter(expr)
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(tfilter.parse_filter(expr).evaluate(fields), want)


@pytest.mark.parametrize("num", [0, 7, -12, 999, 1000, 1_234_567, -98_765_432, 10**12])
def test_numbers_match_reference(num):
    assert tnumbers.number_digits(num) == jnumbers.number_digits(num)
    for width in (0, 5, 20):
        assert tnumbers.print_number(num, width) == jnumbers.print_number(num, width)


def test_pack_2bit_np_lengths_matches_reference():
    """Codes at or past a row's length pack as zero: the rows hold garbage
    codes there, and rows of length 0, of the full width and between."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (9, 48)).astype(np.uint8)
    lengths = np.array([0, 1, 3, 4, 5, 17, 47, 48, 30])
    got = ttb.pack_2bit_np(codes, lengths)
    np.testing.assert_array_equal(got, jtb.pack_2bit_np(codes, lengths))
    np.testing.assert_array_equal(ttb.pack_2bit_np(codes), jtb.pack_2bit_np(codes))
    assert not (got[0] != 0).any() and (got != ttb.pack_2bit_np(codes)).any()


@pytest.mark.parametrize("kw", [dict(), dict(n_reads=5, min_len=0, max_len=3, with_pw=False),
                                dict(n_reads=3, with_qv=False, gz=False),
                                dict(movie=b"m_other", max_len=301)])
def test_make_bam_matches_conftest(kw):
    got, recs = testing.make_bam(np.random.default_rng(8), **kw)
    want, wrecs = conftest_make_bam(np.random.default_rng(8), **kw)
    assert got == want
    assert [r["qname"] for r in recs] == [r["qname"] for r in wrecs]


def test_make_bam_takes_lengths():
    lengths = [0, 1, 2, 3000, 7]
    _, recs = testing.make_bam(np.random.default_rng(1), lengths=lengths)
    assert [r["ln"] for r in recs] == lengths


def _run(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


def _inputs(kind, d):
    """Write the input of one case into ``d``; returns its file names."""
    rng = np.random.default_rng(21)
    if kind == "bax":
        from dextractor_tpu_torch.native import hdf5_shim
        try:
            hdf5_shim()
        except OSError as e:
            pytest.skip(f"libhdf5 unavailable: {e}")
        make_bax_file(str(d / "x.bax.h5"), rng)
        return ["x.bax.h5"]
    bam, recs = conftest_make_bam(rng, n_reads=7, min_len=300, max_len=900,
                                  gz=kind != "plain_bam")
    if kind == "sam":
        (d / "s.subreads.sam").write_bytes(_bam_to_sam_text(recs))
        return ["s.subreads.sam"]
    if kind == "no_pw":
        bam, _ = conftest_make_bam(rng, n_reads=3, with_pw=False)
    (d / "a.subreads.bam").write_bytes(bam)
    bam2, _ = conftest_make_bam(rng, n_reads=4, min_len=550, max_len=800, movie=b"m_two")
    (d / "b.subreads.bam").write_bytes(bam2)
    return ["a.subreads.bam", "b.subreads.bam"]


@pytest.mark.parametrize("kind,args", [
    ("bam", ["-f", "-q", "-a", "-eln>=0"]),
    ("bam", ["-v"]),                                 # fasta only, the default filter
    ("bam", ["-q", "-a", "-ozz"]),                   # one output set for both inputs
    ("plain_bam", ["-f", "-q", "-ezm<3 || ln>700"]),
    ("sam", ["-f", "-q", "-a", "-eln>=0"]),
    ("no_pw", ["-a", "-eln>=0"]),                    # fails; partial outputs removed
    ("bax", ["-f", "-q", "-a", "-eln>=0"]),
    ("bax", ["-q", "-erq>800"]),
])
def test_dextract_matches_reference(tmp_path, kind, args):
    """The port's dextract writes the same .fasta/.arrow/.quiva bytes as the
    JAX package's, and fails the same way.  Both read one copy of the inputs
    (a gzip header holds the second it was written in)."""
    src = tmp_path / "inputs"
    src.mkdir()
    files = _inputs(kind, src)
    outs = {}
    for name, main in (("jax", jax_dextract), ("port", dextract)):
        d = tmp_path / name
        shutil.copytree(src, d)
        rc = _run(main, args + files, d)
        outs[name] = (rc, _files(d))
    assert outs["port"] == outs["jax"]
    rc, files = outs["port"]
    written = [f for f in files if f.endswith((".fasta", ".arrow", ".quiva"))]
    assert (rc, bool(written)) == ((1, False) if kind == "no_pw" else (0, True))
