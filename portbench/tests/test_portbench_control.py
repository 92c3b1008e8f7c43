"""Every cell's check has to fail on the control (the program's own lossy
path, ``dexqv -l``) and on each fault that the cell can have, planted in
the timed path under a run that otherwise runs as the benchmark's: an
answer altered where it is produced, and half of a batch left out."""

import pytest
import torch

from tiny import CELLS, run


@pytest.mark.parametrize("workload", CELLS)
def test_the_lossy_control_is_not_correct(workload):
    result, checks = run(workload, lossy=True)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())


def _altered(fn, where):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        return where(out)
    return wrapped


def _flip_byte(b: bytes) -> bytes:
    i = len(b) // 2
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _flip_symbol(rows):
    rows = rows.clone()
    rows[2, 0, 0] ^= 1
    return rows


def _half_rows(rows):
    rows = rows.clone()
    rows[:, rows.shape[1] // 2:] = 0
    return rows


def _flip_word(out):
    words = out[0].clone()
    words[1, 0, 0] ^= 1
    return (words, *out[1:])


def _half_step(out):
    words, raw, outw, dup, zext, packed, clens = (x.clone() for x in out)
    n = raw.shape[1] // 2
    raw[:, n:] = 0
    outw[:, n:] = 0
    clens[n:] = 0
    return words, raw, outw, dup, zext, packed, clens


def _half_batch(fn):
    """The step on the first half of its reads: the rest left out."""
    def wrapped(streams, lengths, *a, **k):
        lengths = lengths.clone()
        lengths[len(lengths) // 2:] = 0
        return fn(streams, lengths, *a, **k)
    return wrapped


FAULTS = {
    "rs2-p6.restore": [
        ("dextractor_tpu_torch.codecs.qv_codec", "decode_dexqv_to_quiva",
         lambda f: _altered(f, _flip_byte)),
        ("dextractor_tpu_torch.ops.decode2", "decode_entry_batch_seg",
         lambda f: _altered(f, _half_rows)),
    ],
    "rs2-2kb.compress": [
        ("dextractor_tpu_torch.codecs.qv_codec", "encode_quiva_to_dexqv",
         lambda f: _altered(f, _flip_byte)),
        ("dextractor_tpu_torch.codecs.qv_codec", "qv_encode_step", _half_batch),
    ],
    "rs2-p6.decode_step": [
        ("dextractor_tpu_torch.ops.decode2", "decode_entry_batch_seg",
         lambda f: _altered(f, _flip_symbol)),
        ("dextractor_tpu_torch.ops.decode2", "decode_entry_batch_seg",
         lambda f: _altered(f, _half_rows)),
    ],
    "rs2-2kb.encode_step": [
        ("dextractor_tpu_torch.parallel.pipeline", "qv_encode_step",
         lambda f: _altered(f, _flip_word)),
        ("dextractor_tpu_torch.parallel.pipeline", "qv_encode_step",
         lambda f: _altered(f, _half_step)),
    ],
}


@pytest.mark.parametrize("fault", [0, 1], ids=["answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    import importlib

    mod_name, attr, wrap = FAULTS[workload][fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    result, checks = run(workload)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())
    assert isinstance(torch.zeros(1), torch.Tensor)
