"""Ragged <-> padded-rectangle conversions (host side, vectorized NumPy).

Device kernels want rectangular (N, Lpad) layouts with a length vector; file
containers want tightly packed variable-length byte runs.  These helpers are
the bridge and are used by every codec.  The port's own copy of
``dextractor_tpu/formats/ragged.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Ragged:
    """A batch of variable-length u8 rows stored flat."""

    flat: np.ndarray      # (total,) u8
    lengths: np.ndarray   # (N,) int64

    @property
    def offsets(self) -> np.ndarray:
        off = np.zeros(len(self.lengths) + 1, np.int64)
        np.cumsum(self.lengths, out=off[1:])
        return off


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def bucket_len(x: int, floor: int = 512) -> int:
    """Round up to eighth-power-of-two granularity (512, 576, ..., 1024,
    1152, 1280, ..., 2048, 2304, ...): padded widths waste at most 12.5%.
    The granularity comes from the power of two below x."""
    x = max(int(x), floor)
    gran = max(floor // 8, (1 << (x.bit_length() - 1)) // 8)
    return (x + gran - 1) // gran * gran


def bucket_rows(n: int, floor: int = 8) -> int:
    """Row-count bucket: round up to eighth-power-of-two granularity, so
    every plane op pays at most 12.5% dead rows."""
    n = max(int(n), floor)
    gran = max(1, (1 << (n.bit_length() - 1)) // 8)
    return (n + gran - 1) // gran * gran


def padded_width(lengths: np.ndarray, align: int = 512, bucket: bool = False) -> int:
    """The width of ``pad_rows``' rectangle for rows of ``lengths``."""
    lpad = _round_up(max(int(np.max(lengths, initial=0)), 1), align)
    if bucket:
        lpad = _round_up(lpad, max(align, (1 << (lpad.bit_length() - 1)) // 8))
    return lpad


def pad_rows(flat: np.ndarray, lengths: np.ndarray, align: int = 512,
             pad_value: int = 0, bucket: bool = False) -> np.ndarray:
    """Scatter flat ragged rows into an (N, Lpad) rectangle.

    With ``bucket``, Lpad is rounded to quarter-octave granularity (kept
    a multiple of ``align``), so the kernels see few distinct widths and
    at most ~12.5% dead columns.
    """
    n = len(lengths)
    lpad = padded_width(lengths, align, bucket)
    out = np.full((n, lpad), pad_value, dtype=flat.dtype)
    total = int(lengths.sum())
    if total:
        starts = np.zeros(n, np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        row = np.repeat(np.arange(n, dtype=np.int64), lengths)
        col = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
        out[row, col] = flat[:total]
    return out


def rows_to_flat(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Gather the first lengths[i] items of each row into one flat array."""
    n, lpad = rows.shape
    total = int(lengths.sum())
    if not total:
        return np.empty(0, rows.dtype)
    starts = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    row = np.repeat(np.arange(n, dtype=np.int64), lengths)
    col = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
    return rows[row, col]


def flat_gather_lens(flat: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Gather ragged runs flat[starts[i] : starts[i]+lengths[i]] concatenated."""
    total = int(lengths.sum())
    if not total:
        return np.empty(0, flat.dtype)
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    # the native memcpy path cannot bounds-check; malformed runs (e.g. a
    # corrupt container yielding negative lengths) must take the NumPy
    # path below, which raises instead of corrupting the heap
    valid = bool(len(starts) == len(lengths)
                 and (lengths >= 0).all() and (starts >= 0).all()
                 and (starts + lengths <= len(flat)).all())
    if flat.dtype.itemsize == 1 and valid:
        try:          # one memcpy per run; the fancy-index gather below
            from ..native import qv_encode_shim   # costs ~16 index bytes/byte
            import ctypes

            lib = qv_encode_shim()
            out = np.empty(total, flat.dtype)
            ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
            lib.dxt_gather_copy(
                ptr(out), ptr(np.ascontiguousarray(flat)),
                ptr(np.ascontiguousarray(starts, np.int64)),
                ptr(np.ascontiguousarray(lengths, np.int64)), len(lengths))
            return out
        except OSError:
            pass
    run_starts = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=run_starts[1:])
    idx = (np.arange(total, dtype=np.int64) - np.repeat(run_starts, lengths)
           + np.repeat(starts, lengths))
    return flat[idx]
