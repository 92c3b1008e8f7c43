"""The port's .dexqv encode end to end against the JAX package, the CLI, and
the port's independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_quiva as conftest_make_quiva
from dextractor_tpu.codecs.qv_codec import encode_quiva_to_dexqv as jax_encode

from dextractor_tpu_torch import testing
from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.utils import dispatch

REPO = Path(__file__).resolve().parent.parent

CORPORA = {
    "default": dict(seed=1, n_reads=20, max_len=600),
    "sub_heavy": dict(seed=3, n_reads=30, min_len=6700, max_len=7000, sub_heavy=True),
    "empty_reads": dict(seed=4, lengths=[0, 5, 0, 0, 17, 0, 1]),
    "long_read": dict(seed=5, lengths=[9000, 100, 12000]),
    "no_del_run": dict(seed=6, n_reads=10, max_len=300, del_run=False),
}


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, kw in CORPORA.items():
        kw = dict(kw)
        out[name] = testing.make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    return out


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("name", list(CORPORA))
def test_encode_matches_reference(corpora, name, lossy):
    data = corpora[name]
    ref = jax_encode(data, lossy=lossy, device=False)
    dispatch.reset_counts()
    assert tq.encode_quiva_to_dexqv(data, lossy=lossy, device="cpu") == ref
    assert dispatch.TWIN_CALLS["encode_plain"] > 0
    assert tq.encode_quiva_to_dexqv(data, lossy=lossy, device=False) == ref


def test_encode_matches_reference_device_path(corpora):
    """Once, against the JAX package's own batched device path (XLA on the
    CPU); the other tests hold the port to its native encoder."""
    data = corpora["default"]
    assert tq.encode_quiva_to_dexqv(data, device="cpu") == jax_encode(data, device=True)


def test_device_request_without_cuda_raises(corpora, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tq.encode_quiva_to_dexqv(corpora["default"], device=True)
    monkeypatch.setenv("DXT_DEVICE", "1")
    with pytest.raises(RuntimeError):
        tq.encode_quiva_to_dexqv(corpora["default"])
    monkeypatch.setenv("DXT_DEVICE", "0")
    assert dispatch.resolve_device(None) is None


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_cli_dexqv(corpora, tmp_path):
    src = tmp_path / "g.quiva"
    src.write_bytes(corpora["default"])
    r = subprocess.run([sys.executable, "-m", "dextractor_tpu_torch", "dexqv", "-k",
                        str(src)], capture_output=True, text=True, env=_env(),
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert src.exists()
    assert (tmp_path / "g.dexqv").read_bytes() == jax_encode(corpora["default"],
                                                             device=False)


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter: import every module of the port (ops.tag,
    ops.bitstream, ops.decode_torch, tools.decode_ablate, tools.multichip,
    tools.step_verify, tools.encode_split, parallel.mesh,
    parallel.multihost, ingest, db, cli.dextract and cli.dex2DB among them)
    and chip_smoke, load the HDF5 shim where libhdf5
    is, encode and decode (.dexqv and .dexta) on the CPU, run the CLI (dexqv,
    dexta, undexta), and rehearse
    every phase of chip_smoke on the CPU at the smallest sizes that reach
    each branch (the wrappers run their twins there; tests/test_torch_decode_*
    cover the decode at larger sizes), phase 14 without its two processes
    (tests/test_torch_parallel.py spawns them), phase 15 with two shards, and
    chip_smoke's ``--out`` record.  Neither jax nor the JAX package may be imported."""
    path, rpath = str(tmp_path / "a.quiva"), str(tmp_path / "record.json")
    fpath, dpath = str(tmp_path / "g.fasta"), str(tmp_path / "g.dexta")
    code = f"""
import importlib, pkgutil, sys
import numpy as np
import dextractor_tpu_torch
for m in pkgutil.walk_packages(dextractor_tpu_torch.__path__, "dextractor_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
for m in ("ops.tag", "ops.bitstream", "tools.decode_ablate", "ingest.sam", "ingest.bax",
          "db.access", "db.build", "db.qvtrack", "cli.dextract", "cli.dex2DB",
          "tools.multichip", "parallel.mesh", "parallel.multihost", "ops.decode_torch",
          "tools.step_verify", "tools.encode_split"):
    assert "dextractor_tpu_torch." + m in sys.modules
from dextractor_tpu_torch.native import hdf5_shim
try:
    hdf5_shim()
except OSError:
    pass
import chip_smoke
from dextractor_tpu_torch.cli import main
from dextractor_tpu_torch.codecs.qv_codec import decode_dexqv_to_quiva, encode_quiva_to_dexqv
from dextractor_tpu_torch.testing import make_quiva
d = make_quiva(np.random.default_rng(0), n_reads=6)
enc = encode_quiva_to_dexqv(d, device="cpu")
assert enc == encode_quiva_to_dexqv(d, device=False)
assert decode_dexqv_to_quiva(enc, device="cpu") == d == decode_dexqv_to_quiva(enc, device=False)
open({path!r}, "wb").write(d)
assert main(["dexqv", "-vk", {path!r}]) == 0
small = make_quiva(np.random.default_rng(0), n_reads=24, min_len=300, max_len=700)
# subQV is RLE from 200,000 symbols on: short reads keep the twins' walks short
sub = make_quiva(np.random.default_rng(7), n_reads=700, min_len=280, max_len=300,
                 sub_heavy=True)
# a read over 8,192 symbols takes the encode's emission route (K9/K8), one
# over 2,048 the segmented decode
longr = make_quiva(np.random.default_rng(2), lengths=[8300, 100, 2100])
cases = [("uniform", small, False), ("sub_heavy", sub, False),
         ("sub_heavy_lossy", sub, True), ("long_reads", longr, False)]
chip_smoke.phase_encode_kernels("cpu", small, longr, wide_len=600)
chip_smoke.widest_fused_plain(longr, "cpu")
chip_smoke.widest_fused_run(longr, "cpu")
chip_smoke.widest_tags(longr, "cpu")
_, _, encoded = chip_smoke.phase_encode_slice("cpu", cases)
chip_smoke.phase_encode_step("cpu", small, longr)
chip_smoke.phase_decode_kernels("cpu", encoded, long_len=600, row_len=300)
chip_smoke.phase_decode_slice("cpu", encoded, segmented=False)
chip_smoke.phase_decode_slice("cpu", encoded)
chip_smoke.phase_decode_step("cpu", encoded[0][3])
chip_smoke.phase_tag_kernel("cpu", encoded, long_len=600)
chip_smoke.phase_decode_ablate("cpu", mb=0)
from dextractor_tpu_torch.codecs.twobit_codec import decode_dexta_to_fasta, encode_fasta_to_dexta
from dextractor_tpu_torch.testing import make_arrow, make_fasta
fa = make_fasta(np.random.default_rng(0), n_reads=30, min_len=0, max_len=500)
assert decode_dexta_to_fasta(encode_fasta_to_dexta(fa, device="cpu"), device=False) == fa
open({fpath!r}, "wb").write(fa)
assert main(["dexta", "-k", {fpath!r}]) == 0
assert main(["undexta", "-v", "-w60", {dpath!r}]) == 0
tcases = [("uniform_fasta", fa, False),
          ("long_fasta", make_fasta(np.random.default_rng(2), lengths=[2100, 0, 700]), False),
          ("uniform_arrow", make_arrow(np.random.default_rng(0), n_reads=20), True)]
chip_smoke.phase_twobit_kernels("cpu", tcases, long_len=600)
chip_smoke.phase_twobit_slice("cpu", tcases)
from dextractor_tpu_torch.testing import make_bam
bams = [("uniform", make_bam(np.random.default_rng(0), n_reads=5, min_len=50, max_len=200)[0]),
        ("long_reads", make_bam(np.random.default_rng(2), lengths=[300, 120])[0])]
import tempfile
# phase 14: a read over 2,048 symbols reaches the segmented route
mixed = make_quiva(np.random.default_rng(4), lengths=[2100, 40, 0, 300])
with tempfile.TemporaryDirectory() as d:
    chip_smoke.phase_db("cpu", bams, every=2, workdir=d)
    chip_smoke.phase_multichip("cpu", [("uniform", make_quiva(np.random.default_rng(0))),
                                       ("long_reads", longr)],
                               [("mixed", mixed, encode_quiva_to_dexqv(mixed, device=False))],
                               fa, d + "/both", shards=(2,), backend="gloo", spawn=False)
# phase 15: the v1 decoders on a read over 2,048 symbols, the encode step's
# tools with the long-read corpus's widest bucket on the emission route
chip_smoke.phase_v1_surface("cpu", [("small", encode_quiva_to_dexqv(small, device=False)),
                                    ("mixed", encode_quiva_to_dexqv(mixed, device=False))],
                            fa, small, longr, shards=(2,))
import json, os
assert chip_smoke.main([]) == 1                   # no card: no result
rec = chip_smoke.RunRecord({rpath!r})
with rec.phase("one"):
    pass
rec.write()
r = json.load(open({rpath!r}))
assert r["phases"] == [dict(name="one", ok=True, seconds=r["phases"][0]["seconds"])], r
assert r["git_head"] is None or len(r["git_head"]) == 40, r
print(sorted(m for m in sys.modules if m in ("jax", "dextractor_tpu")
             or m.startswith(("jax.", "dextractor_tpu."))))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    assert "encode+assemble" in r.stderr          # the -v stage table
    assert "[decode] long_reads (segmented route)" in r.stdout
    assert "[decode] long_reads (per_read route)" in r.stdout
    assert "1 through K9/K8" in r.stdout
    assert "[2-bit] uniform_arrow" in r.stdout
    assert "pack2bit tile edges" in r.stdout
    assert "equals the TAG rows of its full decode" in r.stdout
    assert "ABLATE: " in r.stdout and "[ablate] launches" in r.stdout
    for route in ("fused", "walk", "scheme"):
        assert f"[db] both ({route} route, ascii mode 1)" in r.stdout
    for route in ("segmented", "per_read"):
        assert f"decode_dexqv_to_quiva mixed ({route} route): equal on [2]" in r.stdout
    assert "one-rank gloo group, 2 shards" in r.stdout
    assert "[multichip] phase 14: " in r.stdout
    assert '"step_bytes_ok": true' in r.stdout and "SPLIT: " in r.stdout
    assert "[v1] phase 15: " in r.stdout and "equal to one device" in r.stdout


def test_chip_smoke_reads_ptxas():
    """chip_smoke's ptxas summary: one entry per compiled kernel, named from
    the mangled symbol (nvcc's prefix for an anonymous namespace may end in
    digits, and its length may span the kernel's name too; a template kernel
    comes once per instance), with its registers,
    shared memory and spills."""
    import chip_smoke

    out = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_INTERNAL_d957892a_9_decode_cu_090f3c9c19decode_plain_kernelENS_13PlainChannelsE' for 'sm_90a'
ptxas info    : Function properties for _ZN40_INTERNAL_d957892a_9_decode_cu_090f3c9c19decode_plain_kernelENS_13PlainChannelsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 5184 bytes smem, 552 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117lut_gather_kernelIhLb1EEEvPKT_PKiPix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117lut_gather_kernelIhLb1EEEvPKT_PKiPix
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 20 registers, 1024 bytes smem
ptxas info    : Compiling entry function '_ZN40fe1_7_emit_cu_b18bf7b716pack_tags_kernelEPKhS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN40fe1_7_emit_cu_b18bf7b716pack_tags_kernelEPKhS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 4648 bytes smem
"""
    assert chip_smoke.ptxas_summary(out) == [
        ("decode_plain_kernel", "Used 40 registers, used 1 barriers, 5184 bytes smem, 552 "
         "bytes cmem[0]; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("lut_gather_kernel", "Used 20 registers, 1024 bytes smem; 8 bytes stack frame, 4 "
         "bytes spill stores, 4 bytes spill loads"),
        ("pack_tags_kernel", "Used 48 registers, used 1 barriers, 4648 bytes smem; 0 bytes "
         "stack frame, 0 bytes spill stores, 0 bytes spill loads")]


@pytest.mark.parametrize("kw", [dict(), dict(sub_heavy=True, del_run=False),
                                dict(lengths=[3, 0, 700], spread=10)])
def test_make_quiva_matches_conftest(kw):
    a = testing.make_quiva(np.random.default_rng(9), **kw)
    b = conftest_make_quiva(np.random.default_rng(9), **kw)
    assert a == b
