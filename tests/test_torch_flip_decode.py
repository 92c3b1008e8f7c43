"""A .dexqv written on a host of the other byte order: the port decodes it on
its Python walker (codecs/qv_codec.decode_entry, ops/bitstream.py) in every
``device`` mode, to the original text and to the JAX package's decode of
the same bytes; and the port's decode_entry against the JAX package's on
every entry of an ordinary file."""

import functools

import numpy as np
import pytest
import torch

from test_endian_flip import _flipped_dexqv

from dextractor_tpu.codecs.qv_codec import decode_dexqv_to_quiva as jax_decode
from dextractor_tpu.codecs.qv_codec import decode_entry as jax_decode_entry
from dextractor_tpu.formats import dexqv as jdq

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.testing import make_quiva
from dextractor_tpu_torch.utils import dispatch
from dextractor_tpu_torch.utils.profiling import REPORTER

CORPORA = {
    # delQV run-coded (delChar), subQV plain
    "run_del": dict(seed=24, n_reads=12, min_len=1, max_len=400),
    # delQV plain (no delChar): no run scheme in the coding
    "plain_del": dict(seed=25, n_reads=8, min_len=1, max_len=200, del_run=False),
    # delQV and subQV both run-coded: subChar needs >= 200,000 symbols
    "sub_run": dict(seed=7, n_reads=700, min_len=280, max_len=300, sub_heavy=True),
}


@functools.lru_cache(maxsize=None)
def _flipped(name):
    """(original .quiva, its .dexqv as a host of the other byte order writes it)."""
    kw = dict(CORPORA[name])
    quiva = make_quiva(np.random.default_rng(kw.pop("seed")), **kw)
    return quiva, _flipped_dexqv(quiva)


@pytest.mark.parametrize("name", list(CORPORA))
def test_flipped_decodes_in_every_mode(name):
    quiva, image = _flipped(name)
    coding, _ = tdq.parse_qvcoding(memoryview(image), 2)
    assert coding.flip
    assert (coding.del_char >= 0) == (name != "plain_del")
    assert (coding.sub_char >= 0) == (name == "sub_run")
    assert jax_decode(image) == quiva
    for device in (False, "cpu", None):
        dispatch.reset_counts()
        REPORTER.stages.clear()
        REPORTER.enabled = True
        try:
            assert tq.decode_dexqv_to_quiva(image, device=device) == quiva
        finally:
            REPORTER.enabled = False
        assert "decode (Python walker)" in REPORTER.stages      # the -v stage line
        assert not any(dispatch.LAUNCHES.values()) and not any(dispatch.TWIN_CALLS.values())


@pytest.mark.parametrize("name", ["run_del", "plain_del"])
def test_flipped_upper_and_cuda_request(name, monkeypatch):
    quiva, image = _flipped(name)
    assert tq.decode_dexqv_to_quiva(image, upper=True, device=False) == jax_decode(
        image, upper=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tq.decode_dexqv_to_quiva(image, device=True)


def test_decode_entry_matches_jax_on_every_entry():
    quiva = make_quiva(np.random.default_rng(3), lengths=[0, 1, 5, 300, 2100, 64, 777])
    enc = tq.encode_quiva_to_dexqv(quiva, device=False)
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    jcoding, joff = jdq.parse_qvcoding(memoryview(enc), 2)
    assert off == joff and not coding.flip
    *_, eoffs, elens, _, _ = tq._index_native(enc, coding, off, True)
    buf = np.frombuffer(enc, np.uint8)
    assert len(eoffs) == 7
    for eoff, rlen in zip(eoffs.tolist(), elens.tolist()):
        got, used = tq.decode_entry(coding, buf, eoff, rlen)
        want, jused = jax_decode_entry(jcoding, buf, eoff, rlen)
        assert used == jused and got.shape == (5, rlen)
        assert (got == want).all()
