"""The port's 2-bit codecs (.fasta <-> .dexta, .arrow <-> .dexar) and their
four tools against the JAX package on the CPU: container bytes of the device
pipeline (on the kernels' twins) and of the native host path, decoded text
at every width, legacy and byte-swapped containers, and the CLI."""

import io
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_arrow as conftest_make_arrow
from conftest import make_fasta as conftest_make_fasta
from dextractor_tpu.codecs import twobit_codec as jc

from dextractor_tpu_torch import testing
from dextractor_tpu_torch.cli import main
from dextractor_tpu_torch.codecs import twobit_codec as tc
from dextractor_tpu_torch.formats.dexta import read_dexta
from dextractor_tpu_torch.utils import dispatch

REPO = Path(__file__).resolve().parent.parent
DEVICES = ["cpu", False]

FASTA = {
    "jumps": dict(seed=11, n_reads=40, min_len=0, max_len=600, well_jumps=True),
    "no_rq": dict(seed=12, n_reads=20, min_len=0, max_len=300, with_rq=False),
    "edges": dict(seed=13, lengths=[0, 1, 2, 3, 4, 5, 6, 7, 2000, 0, 81, 160]),
}


@pytest.fixture(scope="module")
def fastas():
    out = {}
    for name, kw in FASTA.items():
        kw = dict(kw)
        out[name] = testing.make_fasta(np.random.default_rng(kw.pop("seed")), **kw)
    return out


@pytest.fixture(scope="module")
def arrow():
    return testing.make_arrow(np.random.default_rng(14), n_reads=40, min_len=0, max_len=600)


@pytest.mark.parametrize("kw", [dict(), dict(min_len=0, well_jumps=True, n_reads=9),
                                dict(with_rq=False, width=7, n_reads=5)])
def test_make_fasta_and_arrow_match_conftest(kw):
    assert (testing.make_fasta(np.random.default_rng(9), **kw)
            == conftest_make_fasta(np.random.default_rng(9), **kw))
    kw = {k: v for k, v in kw.items() if k not in ("with_rq", "well_jumps")}
    assert (testing.make_arrow(np.random.default_rng(9), **kw)
            == conftest_make_arrow(np.random.default_rng(9), **kw))


@pytest.mark.parametrize("name", list(FASTA))
def test_dexta_bytes_match_reference(fastas, name):
    """device="cpu" (the twins) and device=False (native) give the JAX
    package's bytes, native and device path alike."""
    want = jc.encode_fasta_to_dexta(fastas[name], device=False)
    assert jc.encode_fasta_to_dexta(fastas[name], device=True) == want
    for dev in DEVICES:
        assert tc.encode_fasta_to_dexta(fastas[name], device=dev) == want, dev


def test_dexar_bytes_match_reference(arrow):
    want = jc.encode_arrow_to_dexar(arrow, device=False)
    assert jc.encode_arrow_to_dexar(arrow, device=True) == want
    for dev in DEVICES:
        assert tc.encode_arrow_to_dexar(arrow, device=dev) == want, dev


def test_threaded_native_pack(fastas, monkeypatch):
    """The chunk-threaded host pack gives the same bytes."""
    want = tc.encode_fasta_to_dexta(fastas["jumps"], device=False)
    monkeypatch.setattr(tc, "_PACK_THREAD_MIN_BYTES", 1)
    assert tc.encode_fasta_to_dexta(fastas["jumps"], device=False) == want


@pytest.mark.parametrize("name", list(FASTA))
def test_dexta_decode_matches_reference(fastas, name):
    enc = jc.encode_fasta_to_dexta(fastas[name], device=False)
    for width in (0, 1, 7, 80):
        for upper in (False, True):
            want = jc.decode_dexta_to_fasta(enc, width=width, upper=upper, device=False)
            for dev in DEVICES:
                assert tc.decode_dexta_to_fasta(enc, width=width, upper=upper,
                                                device=dev) == want, (width, upper, dev)
    if name != "no_rq":          # headers without RQ decode with RQ=0.0
        assert tc.decode_dexta_to_fasta(enc, device="cpu") == fastas[name]


def test_dexar_decode_matches_reference(arrow):
    enc = jc.encode_arrow_to_dexar(arrow, device=False)
    for width in (0, 1, 7, 80):
        want = jc.decode_dexar_to_arrow(enc, width=width, device=False)
        for dev in DEVICES:
            assert tc.decode_dexar_to_arrow(enc, width=width, device=dev) == want, (width, dev)


def _rewrite(data: bytes, key: int, end: str, fields: str, arrow: bool = False) -> bytes:
    """A container rebuilt with endian key ``key``, header ints in byte
    order ``end`` and per-read fields ``fields`` (struct codes)."""
    d = read_dexta(data, arrow=arrow)
    out = bytearray(struct.pack(end + "Hi", key, len(d.prefix)) + d.prefix)
    offs = d.payload.offsets
    last = 0
    for i in range(len(d.wells)):
        dlt = int(d.wells[i]) - last
        last = int(d.wells[i])
        out += b"\xff" * (dlt // 255) + bytes([dlt % 255])
        vals = [int(d.begs[i]), int(d.ends[i])]
        vals += [int(x) for x in d.cnrs[i]] if arrow else [int(d.qvs[i])]
        out += struct.pack(end + fields, *vals)
        out += d.payload.flat[offs[i]:offs[i + 1]].tobytes()
    return bytes(out)


@pytest.mark.parametrize("key,end,fields", [(0x33CC, "<", "3H"), (0x33CC, ">", "3H"),
                                            (0x55AA, ">", "iii")])
def test_legacy_and_swapped_dexta_decode(fastas, key, end, fields):
    """The legacy key 0x33CC (u16 fields, no-qv layout of old files) and
    byte-swapped keys decode as in the JAX package."""
    enc = _rewrite(jc.encode_fasta_to_dexta(fastas["jumps"], device=False), key, end, fields)
    want = jc.decode_dexta_to_fasta(enc, device=False)
    assert want == fastas["jumps"]
    for dev in DEVICES:
        assert tc.decode_dexta_to_fasta(enc, device=dev) == want, dev


def test_swapped_dexar_decode_and_bad_keys(arrow):
    enc = jc.encode_arrow_to_dexar(arrow, device=False)
    swapped = _rewrite(enc, 0x55AA, ">", "ii4H", arrow=True)
    assert swapped != enc
    want = jc.decode_dexar_to_arrow(swapped, device=False)
    for dev in DEVICES:
        assert tc.decode_dexar_to_arrow(swapped, device=dev) == want, dev
    legacy = _rewrite(enc, 0x33CC, "<", "ii4H", arrow=True)   # .dexar has no legacy key
    for fn in (tc.decode_dexar_to_arrow, jc.decode_dexar_to_arrow):
        with pytest.raises(Exception, match="endian key invalid"):
            fn(legacy, device=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_snr_to_cnr(dtype):
    s = np.array([99.99, 99.995, 100.0, 0.5, 12.345, 99.98], dtype)
    got = tc._snr_to_cnr(s)
    assert got.dtype == np.uint16
    assert np.array_equal(got, jc._snr_to_cnr(s))
    assert got[1:3].tolist() == [9999, 9999]


def test_device_paths_launch_no_kernel_on_cpu(fastas):
    """On the CPU the device pipeline runs the twins; a CUDA request
    without CUDA raises rather than falling back."""
    dispatch.reset_counts()
    tc.decode_dexta_to_fasta(tc.encode_fasta_to_dexta(fastas["edges"], device="cpu"),
                             device="cpu")
    assert dispatch.TWIN_CALLS["pack2bit"] == 1 == dispatch.TWIN_CALLS["unpack2bit"]
    assert not any(dispatch.LAUNCHES.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tc.encode_fasta_to_dexta(fastas["edges"], device=True)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def _run(args, cwd, stdin=None):
    return subprocess.run([sys.executable, "-m", "dextractor_tpu_torch", *args], cwd=cwd,
                          input=stdin, capture_output=True, env=_env(), timeout=120)


def test_cli_pipe_through_python_m(arrow, tmp_path):
    """Through ``python -m dextractor_tpu_torch``: undexar -vi pipes stdin
    to stdout at the -w width and prints the -v stage table."""
    dexar = jc.encode_arrow_to_dexar(arrow, device=False)
    r = _run(["undexar", "-vi", "-w7"], tmp_path, stdin=dexar)
    assert r.returncode == 0, r.stderr
    assert r.stdout == jc.decode_dexar_to_arrow(dexar, width=7, device=False)
    assert b"GB/s" in r.stderr and b"decode" in r.stderr
    assert not any(tmp_path.iterdir())


def _pipe(argv, data, monkeypatch, capsysbinary):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    assert main(argv) == 0
    return capsysbinary.readouterr().out


def test_cli_tools_in_process(fastas, arrow, tmp_path, monkeypatch, capsysbinary):
    """The four tools' file lifecycle, -k, -i, -w and -U, as the JAX
    package's tools behave (tests/test_cli.py)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "g.fasta").write_bytes(fastas["no_rq"])
    assert main(["dexta", "-v", "g.fasta"]) == 0
    assert b"Processing" in capsysbinary.readouterr().err
    assert not (tmp_path / "g.fasta").exists()
    assert (tmp_path / "g.dexta").read_bytes() == jc.encode_fasta_to_dexta(
        fastas["no_rq"], device=False)
    (tmp_path / "g.fasta").write_bytes(fastas["no_rq"])
    assert main(["dexta", "-k", "g.fasta"]) == 0
    assert (tmp_path / "g.fasta").exists()
    assert main(["undexta", "-kU", "-w60", "g.dexta"]) == 0
    assert (tmp_path / "g.fasta").read_bytes() == jc.decode_dexta_to_fasta(
        (tmp_path / "g.dexta").read_bytes(), width=60, upper=True, device=False)
    assert main(["undexta", "-w0", "g.dexta"]) == 0
    assert not (tmp_path / "g.dexta").exists()
    assert (tmp_path / "g.fasta").read_bytes() == jc.decode_dexta_to_fasta(
        jc.encode_fasta_to_dexta(fastas["no_rq"], device=False), width=0, device=False)

    (tmp_path / "g.arrow").write_bytes(arrow)
    assert main(["dexar", "g.arrow"]) == 0
    assert not (tmp_path / "g.arrow").exists()
    assert main(["undexar", "-vk", "-w100", "g.dexar"]) == 0
    assert (tmp_path / "g.dexar").exists()
    assert (tmp_path / "g.arrow").read_bytes() == jc.decode_dexar_to_arrow(
        (tmp_path / "g.dexar").read_bytes(), width=100, device=False)

    enc = _pipe(["dexta", "-i"], fastas["edges"], monkeypatch, capsysbinary)
    assert enc == jc.encode_fasta_to_dexta(fastas["edges"], device=False)
    assert _pipe(["undexta", "-i"], enc, monkeypatch, capsysbinary) == fastas["edges"]
    enc = _pipe(["dexar", "-vi"], arrow, monkeypatch, capsysbinary)
    assert enc == jc.encode_arrow_to_dexar(arrow, device=False)


@pytest.mark.parametrize("argv", [["dexta"], ["undexta", "-z", "x.dexta"],
                                  ["dexta", "-U", "x.fasta"], ["dexar", "-w80", "x.arrow"],
                                  ["undexar", "-U", "x.dexar"], ["dexta", "-i", "x.fasta"],
                                  ["undexar"]])
def test_cli_bad_usage(argv, tmp_path, monkeypatch, capsys):
    """No file, an unknown flag (-U is undexta's alone, -w the decoders'),
    or -i with a file: the usage, exit 1, nothing written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 1
    assert f"Usage: {argv[0]}" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("arg,msg", [("-wabc", "not an integer"),
                                     ("-w-1", "must be non-negative")])
def test_cli_bad_width(arg, msg, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(["undexta", arg, "x.dexta"])
    assert e.value.code == 1
    assert msg in capsys.readouterr().err


def test_cli_missing_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["dexta", "missing.fasta"]) == 1
    assert "Cannot open" in capsys.readouterr().err


def test_read_ending_before_its_start_is_refused(fastas):
    """A read whose end lies 1-3 before its beginning has a payload of 0
    bytes, so the entry walk takes it; its letters cannot be placed, and
    both paths refuse the file."""
    from dextractor_tpu_torch.utils.errors import FormatError

    enc = bytearray(jc.encode_fasta_to_dexta(fastas["edges"], device=False))
    prefix_len = struct.unpack_from("<i", enc, 2)[0]
    off = 6 + prefix_len + 1                 # the first read: length 0, well delta 0
    beg = struct.unpack_from("<i", enc, off)[0]
    struct.pack_into("<i", enc, off + 4, beg - 2)
    for dev in DEVICES:
        with pytest.raises(FormatError, match="end lies before"):
            tc.decode_dexta_to_fasta(bytes(enc), device=dev)
