"""The port's .dexqv and .quiva paths on a host where no native shim builds
(no C compiler): every step takes the JAX package's NumPy fallback (the
scan's histograms, the per-entry encoder, the ragged copies, the Python
walker, the .quiva gather and text scatter), and the bytes are the JAX
package's own."""

import numpy as np
import pytest

from dextractor_tpu.codecs import qv_codec as jqc

from dextractor_tpu_torch import native
from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import quiva as tqv
from dextractor_tpu_torch.testing import lossy_quiva, make_quiva
from dextractor_tpu_torch.utils.profiling import REPORTER

CORPORA = {
    "run_del": dict(seed=31, n_reads=10, min_len=1, max_len=300),
    "plain_del": dict(seed=32, n_reads=6, min_len=1, max_len=200, del_run=False),
}


@pytest.fixture
def no_shim(monkeypatch):
    """Every native shim build raises OSError, as without gcc; the shims
    built before are set aside and put back afterwards."""
    def fail(name):
        raise OSError(f"building {name} failed: no C compiler")

    saved = dict(native._LIBS)
    native._LIBS.clear()
    monkeypatch.setattr(native, "_build_shim", fail)
    yield
    native._LIBS.clear()
    native._LIBS.update(saved)


def _quiva(name):
    kw = dict(CORPORA[name])
    return make_quiva(np.random.default_rng(kw.pop("seed")), **kw)


def _decode_stages(image, device):
    REPORTER.stages.clear()
    REPORTER.enabled = True
    try:
        return tq.decode_dexqv_to_quiva(image, device=device), set(REPORTER.stages)
    finally:
        REPORTER.enabled = False


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("name", list(CORPORA))
def test_encode_decode_without_shim(no_shim, name, lossy):
    quiva = _quiva(name)
    ref = jqc.encode_quiva_to_dexqv(quiva, lossy=lossy, device=False)
    with pytest.raises(OSError):
        native.qv_encode_shim()
    for device in (False, "cpu"):
        assert tq.encode_quiva_to_dexqv(quiva, lossy=lossy, device=device) == ref
    want = lossy_quiva(quiva) if lossy else quiva
    for device in (False, "cpu", None):
        got, stages = _decode_stages(ref, device)
        assert got == want
        assert got == jqc.decode_dexqv_to_quiva(ref)
        assert "decode (Python walker)" in stages               # the -v stage line
    assert (tq.decode_dexqv_to_quiva(ref, upper=True, device="cpu")
            == jqc.decode_dexqv_to_quiva(ref, upper=True))


def test_scan_numpy_branch(no_shim):
    """Just over 100,000 symbols, subQV mostly one character: the scan's
    NumPy branch picks subChar and both run histograms as the JAX package's
    native scan does."""
    quiva = make_quiva(np.random.default_rng(33), n_reads=400, min_len=250,
                       max_len=270, sub_heavy=True)
    q = tqv.parse_quiva(quiva)
    assert 100_000 <= int(q.lengths.sum()) < 110_000
    got = tq.scan_streams(q.streams, q.lengths)
    ref = jqc.scan_streams(q.streams, q.lengths)
    assert got.sub_char >= 0 and got.del_char >= 0
    for field in ("del_hist", "ins_hist", "mrg_hist", "sub_hist", "del_run", "sub_run"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert (got.del_char, got.sub_char, got.tot_char) == (ref.del_char, ref.sub_char,
                                                          ref.tot_char)


def test_quiva_io_without_shim(no_shim):
    quiva = _quiva("run_del")
    q = tqv.parse_quiva(quiva)
    assert tqv.write_quiva(q.prefix, q.wells, q.begs, q.ends, q.qvs, q.lengths,
                           q.streams) == quiva
    assert tqv.write_quiva(q.prefix, q.wells[:0], q.begs[:0], q.ends[:0], q.qvs[:0],
                           q.lengths[:0], q.streams[:, :0]) == b""
