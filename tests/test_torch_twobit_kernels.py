"""The plain twins of the 2-bit kernels (what the CUDA kernels dxt_pack2bit,
K7, and dxt_unpack2bit compute) against the JAX package: its arithmetic
pack_translate / unpack_translate, its pack_2bit over a table gather, and
the Pallas kernel K7 in interpret mode.  Integer codec: every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.formats.ragged import rows_to_flat
from dextractor_tpu.ops import emit_pallas as ep
from dextractor_tpu.ops import twobit as jtb

from dextractor_tpu_torch.ops import pack2bit as pk
from dextractor_tpu_torch.ops import twobit as tb
from dextractor_tpu_torch.utils import dispatch

L = 512
TABLES = {"base": tb.NUMBER_BASE_LUT, "arrow": tb.NUMBER_ARROW_LUT,
          "random": np.random.default_rng(5).integers(0, 4, 256).astype(np.uint8)}


def _rows(seed=29):
    """16 rows of 512 bytes holding every byte value (rows 0-1 in order,
    the rest random) with lengths 0-7, L and random ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (16, L), dtype=np.uint8)
    rows[0, :256] = np.arange(256)
    rows[1] = np.arange(L) % 256
    lengths = np.array([L, L, 0, 1, 2, 3, 4, 5, 6, 7, L - 1, L - 2, L - 3,
                        *rng.integers(8, L, 3)], np.int32)
    return rows, lengths


def _flat(rows, lengths):
    """The rows' bases end to end and the (N+1,) offsets, as tensors."""
    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    return torch.from_numpy(rows_to_flat(rows, lengths)), torch.from_numpy(offs)


def _pack_flat(rows, lengths, lut):
    """K7's wrapper on the CPU (the twin) over the flat reads."""
    flat, offs = _flat(rows, lengths)
    clens = (lengths.astype(np.int64) + 3) >> 2
    couts = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(clens, out=couts[1:])
    return pk.pack2bit(flat, offs, torch.from_numpy(couts), torch.from_numpy(lut),
                       int(couts[-1])).numpy()


def test_tables_equal_the_reference():
    for name in ("NUMBER_BASE_LUT", "NUMBER_ARROW_LUT", "LOWER_LUT", "UPPER_LUT",
                 "ARROW_LETTER_LUT"):
        a, b = getattr(tb, name), getattr(jtb, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert tb.compressed_len(np.arange(9)).tolist() == [0, 1, 1, 1, 1, 2, 2, 2, 2]


@pytest.mark.parametrize("alphabet", ["base", "arrow"])
def test_pack_twin_matches_pack_translate(alphabet):
    """On all 256 byte values the table twin equals the arithmetic
    pack_translate of the JAX package, quirks included ('G'->2 and default 3
    in arrow, every non-acgt byte 0 in base); flat and as rows."""
    rows, lengths = _rows()
    want = np.asarray(jtb.pack_translate(jnp.asarray(rows), jnp.asarray(lengths),
                                         alphabet=alphabet))
    got = tb.pack2bit_twin(torch.from_numpy(rows), torch.from_numpy(lengths),
                           torch.from_numpy(TABLES[alphabet])).numpy()
    assert np.array_equal(got, want)
    clens = (lengths + 3) >> 2
    assert np.array_equal(_pack_flat(rows, lengths, TABLES[alphabet]),
                          rows_to_flat(want, clens))


@pytest.mark.parametrize("table", list(TABLES))
def test_pack_twin_matches_pack_2bit_and_pallas(table):
    """Against pack_2bit(lut[rows]) for each table, a random one included,
    and against K7 itself (pack2bit_pallas, interpret mode), one 16x512
    call as tests/test_emit_pallas.py makes it."""
    rows, lengths = _rows()
    lut = TABLES[table]
    want = np.asarray(jtb.pack_2bit(jnp.asarray(lut)[jnp.asarray(rows)],
                                    jnp.asarray(lengths)))
    got = tb.pack2bit_twin(torch.from_numpy(rows), torch.from_numpy(lengths),
                           torch.from_numpy(lut)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(_pack_flat(rows, lengths, lut),
                          rows_to_flat(want, (lengths + 3) >> 2))
    pallas = np.asarray(ep.pack2bit_pallas(jnp.asarray(rows), jnp.asarray(lengths),
                                           jnp.asarray(lut), interpret=True))
    assert np.array_equal(got, pallas)


def test_pack_twin_rows_of_any_width():
    """Rows whose width is no multiple of 4 pack like the zero-padded ones."""
    rows, lengths = _rows()
    lengths = np.minimum(lengths, 509)
    lut = torch.from_numpy(TABLES["random"])
    got = tb.pack2bit_twin(torch.from_numpy(rows[:, :509].copy()),
                           torch.from_numpy(lengths), lut)
    want = tb.pack2bit_twin(torch.from_numpy(rows), torch.from_numpy(lengths), lut)
    assert torch.equal(got, want[:, :128])


@pytest.mark.parametrize("letters", ["LOWER_LUT", "UPPER_LUT", "ARROW_LETTER_LUT"])
def test_unpack_twin_matches_unpack_translate(letters):
    """All 256 packed byte values through each letter table: as a rectangle,
    and flat with exact read lengths (tails of 0-3 codes dropped)."""
    lut = getattr(tb, letters)
    packed = np.arange(256, dtype=np.uint8).reshape(8, 32)
    want = np.asarray(jtb.unpack_translate(jnp.asarray(packed), jnp.asarray(lut)))
    got = tb.unpack2bit_twin(torch.from_numpy(packed), None, torch.from_numpy(lut))
    assert np.array_equal(got.numpy(), want)

    rlens = np.array([128, 0, 1, 2, 3, 125, 126, 127, 5], np.int64)
    clens = (rlens + 3) >> 2
    rows = np.zeros((len(rlens), 32), np.uint8)
    rows[:8] = packed
    rows[8, :2] = [0x1B, 0xE4]
    pay_offs = np.zeros(len(rlens) + 1, np.int64)
    np.cumsum(clens, out=pay_offs[1:])
    out_offs = np.zeros(len(rlens) + 1, np.int64)
    np.cumsum(rlens, out=out_offs[1:])
    got = pk.unpack2bit(torch.from_numpy(rows_to_flat(rows, clens)),
                        torch.from_numpy(pay_offs), torch.from_numpy(out_offs),
                        torch.from_numpy(lut), int(out_offs[-1]))
    want = np.asarray(jtb.unpack_translate(jnp.asarray(rows), jnp.asarray(lut)))
    assert np.array_equal(got.numpy(), rows_to_flat(want, rlens))


def test_round_trip_and_counts():
    """unpack(pack(x)) gives the bases back through their letters; on the
    CPU each wrapper runs its twin once and launches nothing; an empty batch
    gives empty outputs."""
    rows, lengths = _rows()
    rows = np.frombuffer(b"acgt", np.uint8)[rows % 4]
    dispatch.reset_counts()
    payload = _pack_flat(rows, lengths, tb.NUMBER_BASE_LUT)
    out_offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out_offs[1:])
    pay_offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum((lengths + 3) >> 2, out=pay_offs[1:])
    back = pk.unpack2bit(torch.from_numpy(payload), torch.from_numpy(pay_offs),
                         torch.from_numpy(out_offs), torch.from_numpy(tb.LOWER_LUT),
                         int(out_offs[-1]))
    assert back.numpy().tobytes() == rows_to_flat(rows, lengths).tobytes()
    assert dispatch.TWIN_CALLS["pack2bit"] == 1 == dispatch.TWIN_CALLS["unpack2bit"]
    assert dispatch.LAUNCHES["pack2bit"] == 0 == dispatch.LAUNCHES["unpack2bit"]
    z = torch.zeros(3, dtype=torch.int64)
    empty = torch.zeros(0, dtype=torch.uint8)
    assert pk.pack2bit(empty, z, z, torch.from_numpy(tb.NUMBER_BASE_LUT), 0).numel() == 0
    assert pk.unpack2bit(empty, z, z, torch.from_numpy(tb.LOWER_LUT), 0).numel() == 0


def test_wrappers_refuse_what_they_cannot_run():
    flat = torch.zeros(8, dtype=torch.uint8)
    offs = torch.tensor([0, 3, 8], dtype=torch.int64)
    outs = torch.tensor([0, 1, 3], dtype=torch.int64)
    lut = torch.from_numpy(tb.NUMBER_BASE_LUT)
    with pytest.raises(TypeError):
        pk.pack2bit(flat.long(), offs, outs, lut, 3)
    with pytest.raises(TypeError):
        pk.pack2bit(flat, offs.int(), outs, lut, 3)
    with pytest.raises(ValueError):
        pk.pack2bit(flat, offs, outs[:2], lut, 3)
    with pytest.raises(ValueError):
        pk.pack2bit(flat.reshape(2, 4), offs, outs, lut, 3)
    with pytest.raises(ValueError):
        pk.unpack2bit(flat, offs, outs, lut, 3)          # a 4-letter table
    with pytest.raises(ValueError):     # no kernel and no fallback off CPU/CUDA
        pk.pack2bit(flat.to("meta"), offs.to("meta"), outs.to("meta"),
                    lut.to("meta"), 3)
