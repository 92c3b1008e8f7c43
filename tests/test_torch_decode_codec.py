""".dexqv decode end to end: the port's decode_dexqv_to_quiva on the device
path (device="cpu": the kernels' plain twins) and on the native walker
against the original .quiva and the JAX package's decoder, the routing of
``device``, and ``python -m dextractor_tpu_torch undexqv``."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dextractor_tpu.codecs.qv_codec import decode_dexqv_to_quiva as jax_decode

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.testing import lossy_quiva, make_quiva
from dextractor_tpu_torch.utils import dispatch
from dextractor_tpu_torch.utils.errors import FormatError

REPO = Path(__file__).resolve().parent.parent

CORPORA = {
    "plain_del": dict(seed=1, n_reads=12, max_len=500, del_run=False),
    "run_del": dict(seed=2, n_reads=20, max_len=600),
    "sub_heavy": dict(seed=3, n_reads=90, min_len=2200, max_len=2500, sub_heavy=True),
    "short_reads": dict(seed=4, lengths=[0, 1, 0, 5, 1, 17, 0]),
    "over_2048": dict(seed=5, lengths=[2100, 2049, 2500, 40]),
    "mixed_widths": dict(seed=6, lengths=[100, 2400, 7, 300, 1200, 900, 0, 2048]),
}
CASES = [(name, False) for name in CORPORA] + [("sub_heavy", True), ("run_del", True)]


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, kw in CORPORA.items():
        kw = dict(kw)
        out[name] = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    return out


@pytest.mark.parametrize("name, lossy", CASES)
def test_decode_matches_original_and_reference(corpora, name, lossy):
    data = corpora[name]
    enc = tq.encode_quiva_to_dexqv(data, lossy=lossy, device=False)
    want = lossy_quiva(data) if lossy else data
    dispatch.reset_counts()
    assert tq.decode_dexqv_to_quiva(enc, device="cpu") == want
    assert dispatch.TWIN_CALLS["decode_plain"] > 0
    assert not any(dispatch.LAUNCHES.values())
    assert tq.decode_dexqv_to_quiva(enc, device=False) == want
    assert jax_decode(enc, device=False) == want


def _legacy(enc: bytes) -> bytes:
    """The same entries in the legacy container: no container key, and
    16-bit beg/end/qv fields (undexqv.c:103-110)."""
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    wells, begs, ends, qvs, eoffs, _, coffs, _ = tq._index_native(enc, coding, off, True)
    out = bytearray(enc[2:off])
    prev = 0
    for i, w in enumerate(wells.tolist()):
        d = w - prev
        prev = w
        out += b"\xff" * (d // 255) + bytes([d % 255])
        out += struct.pack("<3H", begs[i], ends[i], qvs[i])
        out += enc[eoffs[i]:eoffs[i] + coffs[i, 4]]
    return bytes(out)


def test_decode_upper_and_legacy_container(corpora):
    data = corpora["run_del"]
    enc = tq.encode_quiva_to_dexqv(data, device=False)
    upper = jax_decode(enc, upper=True, device=False)
    assert upper != data
    assert tq.decode_dexqv_to_quiva(enc, upper=True, device="cpu") == upper
    assert tq.decode_dexqv_to_quiva(enc, upper=True, device=False) == upper
    legacy = _legacy(enc)
    assert jax_decode(legacy, device=False) == data
    assert tq.decode_dexqv_to_quiva(legacy, device="cpu") == data
    assert tq.decode_dexqv_to_quiva(legacy, device=False) == data


def test_decode_refuses_what_it_cannot_decode(corpora, monkeypatch):
    enc = tq.encode_quiva_to_dexqv(corpora["run_del"], device=False)
    with pytest.raises(FormatError):
        tq.decode_dexqv_to_quiva(b"\xaa", device=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tq.decode_dexqv_to_quiva(enc, device=True)
    monkeypatch.setenv("DXT_DEVICE", "0")
    dispatch.reset_counts()
    assert tq.decode_dexqv_to_quiva(enc) == corpora["run_del"]
    assert not any(dispatch.TWIN_CALLS.values())     # the native walker ran


def test_cli_undexqv_round_trip(corpora, tmp_path):
    data = corpora["mixed_widths"]
    src = tmp_path / "g.dexqv"
    src.write_bytes(tq.encode_quiva_to_dexqv(data, device=False))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "dextractor_tpu_torch", "undexqv", "-vk",
                        str(src)], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert src.exists()
    assert (tmp_path / "g.quiva").read_bytes() == data
    assert "assemble" in r.stderr               # the -v stage table


@pytest.mark.parametrize("argv", [["undexqv"], ["undexqv", "-i", "g.dexqv"],
                                  ["dexqv", "-kU", "g.quiva"]])
def test_cli_refuses_missing_files_and_unknown_flags(argv, tmp_path, capsys):
    """Each tool takes its own flags (dexqv -vkl, undexqv -vkU) and at least
    one file; anything else prints the usage and exits 1 with no file
    touched."""
    from dextractor_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 1
    assert f"Usage: {argv[0]}" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
