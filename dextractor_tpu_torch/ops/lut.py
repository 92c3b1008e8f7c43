"""Wrappers of the CUDA kernels of the encode step's emission route
(ops/csrc/emit.cu): K9 ``lut_gather``, the 256-entry table lookup of every
symbol and run length, and K8 ``pack_words``, which packs emission planes
into words.  The route runs where ``emit.fused_ok`` sends a bucket past K1
and K2 (parallel/pipeline.py).

As the wrappers of ops/emit.py, each checks device, dtype, shape and
contiguity, allocates its output, launches on ``torch.cuda.current_stream()``,
raises on a non-zero ``cudaError_t`` and counts the launch in
``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes to the kernel's plain
twin (``lut_gather_ref``, ``pack_words_ref``); a tensor on a CUDA device goes
to the kernel or the wrapper raises: nothing falls back.
"""

from __future__ import annotations

import torch

from ..utils import dispatch
from . import bitstream_torch as bt
from .emit import _check, _launch, _route, tile_scratch

_MAX_ROWS = (1 << 31) - 1     # rows are the grid's x dimension
PACK_TILE = 4096              # slots per K8 tile (kTile in emit.cu)
_MAX_SLOTS = 1 << 27          # K8 counts a row's bits in 32 bits


def lut_gather(data, lut):
    """K9 and K9b: ``lut[data]`` as int32 of ``data``'s shape.

    data: any shape, uint8 or int32 (the two callers: u8 symbols, and run
    lengths ``min(run, 255)`` as int32); lut: (256,) int32.  The function's
    domain is [0, 256).  Outside it the two Pallas kernels disagree
    (lut_gather_lane returns ``lut[128 + (d & 127)]``, lut_gather_pallas 0),
    the kernel returns ``lut[d & 255]`` and the twin raises or wraps, so no
    caller passes such an index."""
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data: expected a tensor, got {type(data).__name__}")
    if data.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"data: expected torch.uint8 or torch.int32, got {data.dtype}")
    _check("data", data, data.dtype, data.shape, data.device)
    _check("lut", lut, torch.int32, (256,), data.device)
    if not _route(data):
        return lut_gather_ref(data, lut)
    out = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    if data.numel():
        _launch("lut_gather", dispatch.kernels().dxt_lut_gather, data,
                int(data.dtype == torch.uint8), lut, out, data.numel())
    return out


def lut_gather_ref(data, lut):
    """The plain twin of K9."""
    dispatch.TWIN_CALLS["lut_gather"] += 1
    return bt.lut_gather_plain(data, lut)


def pack_words(v, n):
    """K8: emission planes -> words.

    v (N, M) int32 holding u32 bit patterns, n (N, M) int32 widths in
    [0, 32], with v < 2^n -> words (N, M+1) int32 (u32 bit patterns).
    Emission i of a row lands MSB-first at bit offset cumsum(n)[i] - n[i]
    (QV.c:404-422); every word is written, zeros past a row's last bit."""
    if not isinstance(v, torch.Tensor) or v.dim() != 2:
        raise ValueError("v: expected an (N, M) tensor")
    rows, m = v.shape
    if rows > _MAX_ROWS or m >= _MAX_SLOTS:
        raise ValueError(f"{rows} rows of {m} slots: the kernel takes at most {_MAX_ROWS} "
                         f"rows of fewer than {_MAX_SLOTS} slots")
    _check("v", v, torch.int32, (rows, m), v.device)
    _check("n", n, torch.int32, (rows, m), v.device)
    if not _route(v):
        return pack_words_ref(v, n)
    words = torch.empty((rows, m + 1), dtype=torch.int32, device=v.device)
    if rows:
        n_tiles = rows * max(1, -(-m // PACK_TILE))
        if n_tiles >= 1 << 31:
            raise ValueError(f"{n_tiles} tiles: the kernel takes fewer than 2^31")
        scratch, epoch = tile_scratch(v.device, n_tiles)
        _launch("pack_words", dispatch.kernels().dxt_pack_words, v, n, words, rows, m,
                scratch, epoch)
    return words


def pack_words_ref(v, n):
    """The plain twin of K8: ``bitstream_torch.pack_words`` at width M+1."""
    dispatch.TWIN_CALLS["pack_words"] += 1
    return bt.pack_words(v.long() & 0xFFFFFFFF, n.long(), v.shape[1] + 1)
