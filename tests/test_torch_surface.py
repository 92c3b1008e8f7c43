"""The port's public surface against the JAX package's on the CPU: the 2-bit
device ops of ``ops/twobit.py`` (``pack_2bit``, ``unpack_2bit``,
``pack_translate``, ``unpack_translate``, ``translate``, here on the twins
of K7, the unpack and K9) and its host helpers (``change_read``,
``print_read``), the names that the JAX package's ``ops``, ``codecs``,
``formats`` and ``utils`` export, and ``utils.trace_to``.  Integer ops:
every comparison is exact."""

import importlib
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.ops import twobit as jtb

from dextractor_tpu_torch.ops import twobit as tb
from dextractor_tpu_torch.utils import dispatch

ALL_BYTES = np.arange(256, dtype=np.uint8)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("mask, with_lengths", [(True, True), (False, True), (True, False)])
def test_pack_2bit_matches_jax(mask, with_lengths):
    """Codes 0-3 in rows of 0-40 codes, packed with and without the mask:
    equal to the JAX package's pack_2bit, through K7's twin."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (9, 40)).astype(np.uint8)
    lengths = np.array([0, 1, 3, 4, 5, 17, 39, 40, 22])
    ln = lengths if with_lengths else None
    want = np.asarray(jtb.pack_2bit(jnp.asarray(codes), None if ln is None else
                                    jnp.asarray(ln), mask=mask))
    dispatch.reset_counts()
    got = tb.pack_2bit(torch.from_numpy(codes), None if ln is None else torch.from_numpy(ln),
                       mask=mask)
    assert dispatch.TWIN_CALLS["pack2bit"] == 1
    np.testing.assert_array_equal(_np(got), want)


def test_unpack_2bit_matches_jax_on_every_byte():
    """All 256 byte values, as rows of 0, 1 and 64 bytes."""
    for packed in (ALL_BYTES.reshape(4, 64), ALL_BYTES.reshape(256, 1),
                   np.zeros((3, 0), np.uint8)):
        want = np.asarray(jtb.unpack_2bit(jnp.asarray(packed)))
        np.testing.assert_array_equal(_np(tb.unpack_2bit(torch.from_numpy(packed))), want)
        np.testing.assert_array_equal(want, jtb.unpack_2bit_np(packed))


@pytest.mark.parametrize("lut", ["LOWER_LUT", "UPPER_LUT", "ARROW_LETTER_LUT"])
def test_unpack_translate_matches_jax_on_every_byte(lut):
    packed = ALL_BYTES.reshape(8, 32)
    table = getattr(jtb, lut)
    want = np.asarray(jtb.unpack_translate(jnp.asarray(packed), jnp.asarray(table)))
    dispatch.reset_counts()
    got = tb.unpack_translate(torch.from_numpy(packed), getattr(tb, lut))
    assert dispatch.TWIN_CALLS["unpack2bit"] == 1
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("alphabet", ["base", "arrow"])
def test_pack_translate_matches_jax_on_every_byte(alphabet):
    """Rows holding all 256 byte values in two orders, with lengths that cut
    them anywhere in a byte of codes."""
    rng = np.random.default_rng(2)
    rows = np.stack([ALL_BYTES, ALL_BYTES[::-1], rng.permutation(ALL_BYTES),
                     rng.permutation(ALL_BYTES)])
    lengths = np.array([256, 255, 130, 0])
    want = np.asarray(jtb.pack_translate(jnp.asarray(rows), jnp.asarray(lengths),
                                         alphabet=alphabet))
    got = tb.pack_translate(torch.from_numpy(rows), torch.from_numpy(lengths), alphabet)
    np.testing.assert_array_equal(_np(got), want)
    with pytest.raises(ValueError):
        tb.pack_translate(torch.from_numpy(rows), torch.from_numpy(lengths), "rna")


@pytest.mark.parametrize("lut", ["NUMBER_BASE_LUT", "NUMBER_ARROW_LUT", "CHANGE_CASE_LUT"])
def test_translate_matches_jax_on_every_byte(lut):
    """Every byte value through each 256-entry table, as u8 and as int32
    data, through K9's twin; the result has the table's dtype."""
    data = np.concatenate([ALL_BYTES, ALL_BYTES[::3]]).reshape(2, -1)
    want = np.asarray(jtb.translate(jnp.asarray(data), jnp.asarray(getattr(jtb, lut))))
    dispatch.reset_counts()
    for x in (data, data.astype(np.int32)):
        got = tb.translate(torch.from_numpy(x), getattr(tb, lut))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(_np(got), want)
    assert dispatch.TWIN_CALLS["lut_gather"] == 2


def test_host_helpers_match_jax():
    """CHANGE_CASE_LUT, change_read and print_read at widths 1, 7 and 80."""
    np.testing.assert_array_equal(tb.CHANGE_CASE_LUT, jtb.CHANGE_CASE_LUT)
    seq = np.frombuffer(b"acgtACGTnNacgtxx", np.uint8)
    np.testing.assert_array_equal(tb.change_read(seq), jtb.change_read(seq))
    codes = np.random.default_rng(3).integers(0, 4, 200).astype(np.uint8)
    for width in (1, 7, 80):
        assert tb.print_read(codes, width) == jtb.print_read(codes, width)
    assert tb.print_read(codes[:0]) == jtb.print_read(codes[:0]) == b""


def test_device_ops_raise_without_a_card(monkeypatch):
    """A NumPy array goes to the card, so on a host with no card the op
    raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.unpack_2bit(ALL_BYTES.reshape(4, 64))


@pytest.mark.parametrize("sub", ["ops", "codecs", "formats", "utils"])
def test_exports_match_the_jax_package(sub):
    """Every name that the JAX package's subpackage exports imports from the
    port's subpackage of the same name."""
    jmod = importlib.import_module(f"dextractor_tpu.{sub}")
    names = [n for n, v in vars(jmod).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    assert names
    port = importlib.import_module(f"dextractor_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for n in names:     # a function for a function (jitted or not), a table for a table
        assert callable(getattr(port, n)) == callable(getattr(jmod, n)), n


def test_trace_to_writes_a_chrome_trace(tmp_path):
    from dextractor_tpu_torch.utils import trace_to

    logdir = tmp_path / "trace"
    with trace_to(str(logdir)):
        torch.ones(64).cumsum(0)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        assert "traceEvents" in json.load(f)
