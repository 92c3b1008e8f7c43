"""Wrappers of the CUDA encode kernels K1-K3 (ops/csrc/emit.cu).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on ``torch.cuda.current_stream()``, raises if the C entry
point returns a non-zero ``cudaError_t``, and counts the launch in
``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes to the kernel's plain
PyTorch twin; a tensor on a CUDA device goes to the kernel or the wrapper
raises — nothing falls back.

Words are int32 tensors holding u32 bit patterns.  The kernels leave the
words of a row past ceil(t/32) unwritten: read a row up to that count.
"""

from __future__ import annotations

import torch

from ..utils import dispatch
from . import bitstream_torch as bt

_MAX_WIDTH = 1 << 30    # the kernels index columns with 32-bit ints
TILE_MIN = 512          # symbols per K1-K3 tile, at least (kPlainTileMin in emit.cu)
_EPOCHS = 1 << 30       # the epochs of K1-K3 and K8 are 30 bits
_TILE_SCRATCH = {}      # (device, stream) -> [tile states, last epoch]


def fused_ok(width: int) -> bool:
    """Does the encode step send rows of ``width`` symbols through K1/K2?

    The JAX package's rule (``emit_pallas.fused_ok``): a width that is a
    multiple of 512 and at most 8,192; every other bucket takes the
    emission route, K9 for the table lookups and K8 for the packing
    (parallel/pipeline.py), so both packages route every bucket alike.  The
    limit was the TPU's VMEM; on the card K1 and K2 take rows of any width,
    and PERF.md holds the card's own comparison of the two routes."""
    return width % 512 == 0 and width <= 8192


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(data) -> bool:
    """True for the kernel (CUDA), False for the twin (CPU)."""
    if data.device.type == "cpu":
        return False
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    return True


def _launch(name, fn, *args):
    """Call C entry point ``fn`` on the current stream of the device of the
    first tensor argument (tensors pass as data pointers) and count the
    launch under ``name``; raise on a non-zero ``cudaError_t``."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")
    dispatch.LAUNCHES[name] += 1


def tile_scratch(dev, n_tiles: int):
    """The tile-state scratch of K1-K3 and K8 on the current stream of ``dev``
    (two u64 counters and a 32-byte state per tile), zeroed once when
    allocated, and the next launch's epoch.  The tile states carry the
    epoch of the launch that wrote them, so no launch has to clear them; a
    new scratch is allocated when the epochs run out."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    need = 16 + 32 * n_tiles
    ent = _TILE_SCRATCH.get(key)
    if ent is None or ent[0].numel() < need or ent[1] + 1 >= _EPOCHS:
        size = max(need, 2 * ent[0].numel() if ent else 0)
        ent = _TILE_SCRATCH[key] = [torch.zeros(size, dtype=torch.uint8, device=dev), 0]
    ent[1] += 1
    return ent[0], ent[1]


def _row_tiles(dev, rows: int, l: int):
    """``tile_scratch`` for a launch of K1-K3 over ``rows`` rows of ``l``
    symbols: room for its tiles at the narrowest."""
    n_tiles = rows * max(1, -(-l // TILE_MIN))
    if -(-n_tiles // 4) >= 1 << 31:
        raise ValueError(f"{n_tiles} tiles: the kernels take fewer than 2^33")
    return tile_scratch(dev, n_tiles)


def _check_rows(data, lengths):
    if not isinstance(data, torch.Tensor) or data.dim() != 3:
        raise ValueError("data: expected a (C, N, L) tensor")
    c, n, l = data.shape
    if l >= _MAX_WIDTH:
        raise ValueError(f"row width {l} exceeds {_MAX_WIDTH}")
    _check("data", data, torch.uint8, (c, n, l), data.device)
    _check("lengths", lengths, torch.int32, (n,), data.device)
    return c, n, l


def encode_plain(data, lengths, sym_luts):
    """K1, plain-channel Huffman encode.

    data (C, N, L) u8, lengths (N,) i32, sym_luts (C, 256) i32 packed LUTs
    -> words (C, N, L+1) i32, t (C, N) i32 total bits, last_gran (C, N) i32.
    """
    c, n, l = _check_rows(data, lengths)
    _check("sym_luts", sym_luts, torch.int32, (c, 256), data.device)
    if not _route(data):
        return bt.encode_plain_ref(data, lengths, sym_luts)
    mp = bt.plain_width(l)
    words = torch.empty((c, n, mp), dtype=torch.int32, device=data.device)
    t = torch.empty((c, n), dtype=torch.int32, device=data.device)
    lg = torch.empty((c, n), dtype=torch.int32, device=data.device)
    if c and n:
        scratch, epoch = _row_tiles(data.device, c * n, l)
        _launch("encode_plain", dispatch.kernels().dxt_encode_plain,
                data, lengths, sym_luts, words, t, lg, c, n, l, mp, scratch, epoch)
    return words, t, lg


def encode_run(data, lengths, sym_luts, run_luts, rchars):
    """K2, RLE-channel Huffman encode.

    data (C, N, L) u8, lengths (N,) i32, sym_luts/run_luts (C, 256) i32,
    rchars (C,) i32 -> words (C, N, 2L+2) i32, t (C, N), last_gran (C, N).
    """
    c, n, l = _check_rows(data, lengths)
    _check("sym_luts", sym_luts, torch.int32, (c, 256), data.device)
    _check("run_luts", run_luts, torch.int32, (c, 256), data.device)
    _check("rchars", rchars, torch.int32, (c,), data.device)
    if not _route(data):
        return bt.encode_run_ref(data, lengths, sym_luts, run_luts, rchars)
    mp = bt.run_width(l)
    words = torch.empty((c, n, mp), dtype=torch.int32, device=data.device)
    t = torch.empty((c, n), dtype=torch.int32, device=data.device)
    lg = torch.empty((c, n), dtype=torch.int32, device=data.device)
    if c and n:
        scratch, epoch = _row_tiles(data.device, c * n, l)
        _launch("encode_run", dispatch.kernels().dxt_encode_run,
                data, lengths, sym_luts, run_luts, rchars, words, t, lg,
                c, n, l, mp, scratch, epoch)
    return words, t, lg


def pack_tags(tag_rows, del_rows, lengths, del_char, number_lut):
    """K3, Pack_Tag + Number_Read + Compress_Read (QV.c:810-819).

    tag_rows/del_rows (N, L) u8, lengths (N,) i32, del_char (1,) i32
    (-1: keep every tag), number_lut (256,) u8 2-bit codes (entries in
    [0, 4))
    -> packed (N, ceil(L/4)) u8, zero past each row's (clens+3)//4 bytes,
    and clens (N,) i32, the kept-tag counts.
    """
    if not isinstance(tag_rows, torch.Tensor) or tag_rows.dim() != 2:
        raise ValueError("tag_rows: expected an (N, L) tensor")
    n, l = tag_rows.shape
    if l >= _MAX_WIDTH:
        raise ValueError(f"row width {l} exceeds {_MAX_WIDTH}")
    dev = tag_rows.device
    _check("tag_rows", tag_rows, torch.uint8, (n, l), dev)
    _check("del_rows", del_rows, torch.uint8, (n, l), dev)
    _check("lengths", lengths, torch.int32, (n,), dev)
    _check("del_char", del_char, torch.int32, (1,), dev)
    _check("number_lut", number_lut, torch.uint8, (256,), dev)
    if not _route(tag_rows):
        from ..parallel.pipeline import _pack_tags

        return _pack_tags(tag_rows, del_rows, lengths, del_char, number_lut)
    wb = (l + 3) // 4
    packed = torch.empty((n, wb), dtype=torch.uint8, device=dev)
    clens = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        scratch, epoch = _row_tiles(dev, n, l)
        _launch("pack_tags", dispatch.kernels().dxt_pack_tags,
                tag_rows, del_rows, lengths, del_char, number_lut, packed,
                clens, n, l, wb, scratch, epoch)
    return packed, clens
