"""Wrappers of the CUDA 2-bit kernels (ops/csrc/twobit.cu): ``pack2bit``
(K7, the .dexta/.dexar encode) and ``unpack2bit`` (their decode).

Both take the flat ragged buffers of the container: the reads end to end,
with int64 offsets of N+1 entries, so that read i spans
[offsets[i], offsets[i+1]).  Both kernels own tiles of their flat output,
not reads, and find a tile's reads by a search of the output offsets: K7
4,096 payload bytes a block, whose bases it stages from an aligned start;
the unpack 2,048 letters a warp, 16 a store, from the payload words of each
group's read.  Each wrapper checks device, dtype, shape and
contiguity, allocates its output, launches on
``torch.cuda.current_stream()``, raises if the C entry point returns a
non-zero ``cudaError_t`` and counts the launch in ``utils.dispatch.LAUNCHES``.
A batch without a payload byte launches nothing: there is no work.  A tensor
on the CPU goes to the plain twin in ops/twobit.py; a tensor on a CUDA
device goes to the kernel or the wrapper raises: nothing falls back.
"""

from __future__ import annotations

import torch

from ..utils import dispatch
from . import twobit as tb
from .emit import _check, _launch, _route

_MAX_TILES = (1 << 31) - 1   # a block a tile, the grid's x dimension
PACK_TILE = 4096             # K7: payload bytes a block (twobit.cu kPackTile)
UNPACK_TILE = 16384          # the unpack: letters a block (twobit.cu kUnpackTile)


def _check_offsets(name, offs, dev):
    if not isinstance(offs, torch.Tensor) or offs.dim() != 1 or offs.numel() < 1:
        raise ValueError(f"{name}: expected an (N+1,) tensor")
    _check(name, offs, torch.int64, offs.shape, dev)
    return offs.numel() - 1


def _check_tiles(n_out: int, tile: int):
    if -(-n_out // tile) > _MAX_TILES:
        raise ValueError(f"{n_out} output bytes: the kernel takes at most {_MAX_TILES} "
                         f"tiles of {tile}")


def _check_flat(name, x):
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError(f"{name}: expected a flat (T,) tensor")
    _check(name, x, torch.uint8, x.shape, x.device)
    return x.device


def pack2bit(flat, offsets, out_offsets, lut, n_out: int):
    """K7: Number_Read + Compress_Read of every read.

    flat (T,) u8 ascii bases; offsets (N+1,) i64, read i being
    flat[offsets[i]:offsets[i+1]]; out_offsets (N+1,) i64, the exclusive
    cumsum of ceil(len/4) from 0; lut (256,) u8 codes 0..3 (the kernel
    keeps each entry's low two bits); n_out = out_offsets[N], the payload
    bytes (given, so no host sync reads it; the kernel's grid is its tiles
    of 4,096 bytes).  Returns the payloads end to end, (n_out,) u8: four
    codes a byte, first in bits 7-6, codes past a read's length 0."""
    dev = _check_flat("flat", flat)
    n = _check_offsets("offsets", offsets, dev)
    _check_offsets("out_offsets", out_offsets, dev)
    if out_offsets.numel() != n + 1:
        raise ValueError("offsets and out_offsets must have the same length")
    _check("lut", lut, torch.uint8, (256,), dev)
    _check_tiles(n_out, PACK_TILE)
    if not _route(flat):
        return tb.pack2bit_twin(flat[int(offsets[0]):int(offsets[-1])],
                                offsets.diff(), lut)
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    if n and n_out:
        _launch("pack2bit", dispatch.kernels().dxt_pack2bit,
                flat, offsets, out_offsets, lut, out, n, n_out)
    return out


def unpack2bit(payload, pay_offsets, out_offsets, letter_lut, n_out: int):
    """The 2-bit decode: code c of a read -> letter_lut[c].

    payload (P,) u8, the reads' payloads end to end, read i's ceil(len/4)
    bytes from pay_offsets[i]; pay_offsets (N+1,) i64; out_offsets (N+1,)
    i64, the exclusive cumsum of the read lengths (each below 2^31) from 0;
    letter_lut (4,) u8; n_out = out_offsets[N] (given, so no host sync
    reads it; the kernel's grid is its blocks of 16,384 letters).  Returns
    (n_out,) u8: exactly len letters per read, end to end."""
    dev = _check_flat("payload", payload)
    n = _check_offsets("pay_offsets", pay_offsets, dev)
    _check_offsets("out_offsets", out_offsets, dev)
    if out_offsets.numel() != n + 1:
        raise ValueError("pay_offsets and out_offsets must have the same length")
    _check("letter_lut", letter_lut, torch.uint8, (4,), dev)
    _check_tiles(n_out, UNPACK_TILE)
    if not _route(payload):
        return tb.unpack2bit_twin(payload[int(pay_offsets[0]):int(pay_offsets[-1])],
                                  out_offsets.diff(), letter_lut)
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    if n and n_out:
        _launch("unpack2bit", dispatch.kernels().dxt_unpack2bit,
                payload, pay_offsets, out_offsets, letter_lut, out, n, n_out)
    return out
