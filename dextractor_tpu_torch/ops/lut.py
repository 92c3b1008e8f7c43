"""Wrappers of the CUDA kernels of the encode step's emission route
(ops/csrc/emit.cu): K9 ``lut_gather``, the 256-entry table lookups of the
symbols and run lengths, all of a bucket in one launch, and K8
``pack_words``, which packs emission planes into words.  The route runs
where ``emit.fused_ok`` sends a bucket past K1 and K2 (parallel/pipeline.py).

As the wrappers of ops/emit.py, each checks device, dtype, shape and
contiguity, allocates its output, launches on ``torch.cuda.current_stream()``,
raises on a non-zero ``cudaError_t`` and counts the launch in
``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes to the kernel's plain
twin (``lut_gather_groups_ref``, ``pack_words_ref``); a tensor on a CUDA
device goes to the kernel or the wrapper raises: nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import dispatch
from . import bitstream_torch as bt
from .emit import _check, _launch, _route, tile_scratch

_MAX_ROWS = (1 << 31) - 1     # rows are the grid's x dimension
PACK_TILE = 4096              # slots per K8 tile (kTile in emit.cu)
_MAX_SLOTS = 1 << 27          # K8 counts a row's bits in 32 bits
LUT_GROUPS = 8                # lookups per K9 launch, at most (kLutGroups in emit.cu)


def _check_data(name, data, dev):
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(data).__name__}")
    if data.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"{name}: expected torch.uint8 or torch.int32, got {data.dtype}")
    _check(name, data, data.dtype, data.shape, dev)


def lut_gather_groups(groups, luts):
    """K9 and K9b over several lookups: ``luts[k][data]`` as int32 of
    ``data``'s shape for each ``(data, k)`` of ``groups``, one launch for
    every eight groups (one a bucket on the encode's emission route).

    data: any shape, uint8 or int32 (the route's symbol planes and its run
    planes ``min(run, 255)``); luts: (G, 256) int32, k in [0, G).  The
    function's domain is [0, 256).  Outside it the two Pallas kernels
    disagree (lut_gather_lane returns ``lut[128 + (d & 127)]``,
    lut_gather_pallas 0), the kernel returns ``lut[d & 255]`` and the twin
    raises or wraps, so no caller passes such an index.  A group of 0
    elements gets an empty output and no tile; a launch with no element is
    not made."""
    if not isinstance(luts, torch.Tensor) or luts.dim() != 2:
        raise ValueError("luts: expected a (G, 256) tensor")
    dev = luts.device
    _check("luts", luts, torch.int32, (luts.shape[0], 256), dev)
    for i, (data, k) in enumerate(groups):
        _check_data(f"groups[{i}] data", data, dev)
        if not 0 <= int(k) < luts.shape[0]:
            raise ValueError(f"groups[{i}]: table {k} of {luts.shape[0]}")
    if not _route(luts):
        return lut_gather_groups_ref(groups, luts)
    outs = [torch.empty(data.shape, dtype=torch.int32, device=dev) for data, _ in groups]
    todo = [(data, int(k), out) for (data, k), out in zip(groups, outs) if data.numel()]
    for s in range(0, len(todo), LUT_GROUPS):
        part = todo[s:s + LUT_GROUPS]
        desc = (ctypes.c_longlong * (5 * len(part)))(*[
            x for data, k, out in part
            for x in (data.data_ptr(), int(data.dtype == torch.uint8), k, out.data_ptr(),
                      data.numel())])
        _launch("lut_gather", dispatch.kernels().dxt_lut_gather, len(part),
                ctypes.addressof(desc), luts)
    return outs


def lut_gather_groups_ref(groups, luts):
    """The plain twin of K9: ``bitstream_torch.lut_gather_plain`` per group,
    one twin call a call."""
    dispatch.TWIN_CALLS["lut_gather"] += 1
    return [bt.lut_gather_plain(data, luts[int(k)]) for data, k in groups]


def lut_gather(data, lut):
    """K9 on one lookup: ``lut[data]`` as int32 of ``data``'s shape, data
    uint8 or int32, lut (256,) int32 (the one-group case of
    ``lut_gather_groups``)."""
    _check_data("data", data, getattr(data, "device", None))
    _check("lut", lut, torch.int32, (256,), data.device)
    return lut_gather_groups([(data, 0)], lut[None])[0]


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
