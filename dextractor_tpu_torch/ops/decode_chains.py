"""Wrappers of the CUDA decode-chain kernels K4 and K5 (ops/csrc/decode.cu).

``decode_plain`` runs C plain Huffman channels of the same entries in one
launch (K4a; C = 1 is K4b), ``decode_run`` one RLE channel (K5).  Each
wrapper checks device, dtype, shape and contiguity, allocates its outputs,
launches on ``torch.cuda.current_stream()``, raises if the C entry point
returns a non-zero ``cudaError_t``, and counts the launch in
``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes to the kernel's plain
twin in ops/decode2.py; a tensor on a CUDA device goes to the kernel or the
wrapper raises: nothing falls back.

Rectangles are int32 tensors holding the u32 words of each chain's
stream, every chain starting at word 0 of its row.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import dispatch
from . import decode2 as d2
from .emit import _check, _launch, _route

MAX_CHANNELS = 4          # plain channels one K4 launch takes
SMEM_L2_MAX = 8192        # L2 entries the kernels stage in shared memory (kSmemL2Max)
_MAX_ROWS = (1 << 31) - 1


def _check_l2(f2, lmax, subws, dev):
    if not isinstance(f2, torch.Tensor) or f2.dim() != 1 or f2.numel() == 0:
        raise ValueError("f2: expected a non-empty 1-D tensor")
    _check("f2", f2, torch.int32, f2.shape, dev)
    if lmax not in (8, 12, 16):
        raise ValueError(f"lmax must be 8, 12 or 16, got {lmax}")
    for sw in subws:
        if sw not in (0, 1 << (lmax - 8)):
            raise ValueError(f"subw {sw} does not match lmax {lmax}")


def _check_rect(name, rect, n, dev):
    if not isinstance(rect, torch.Tensor) or rect.dim() != 2 or rect.shape[1] < 1:
        raise ValueError(f"{name}: expected an (N, K) tensor with K >= 1")
    _check(name, rect, torch.int32, (n, rect.shape[1]), dev)


def _check_rlens(rlens):
    if not isinstance(rlens, torch.Tensor) or rlens.dim() != 1:
        raise ValueError("rlens: expected an (N,) tensor")
    if rlens.shape[0] > _MAX_ROWS:
        raise ValueError(f"{rlens.shape[0]} rows: the kernels take at most {_MAX_ROWS}")
    _check("rlens", rlens, torch.int32, rlens.shape, rlens.device)
    return rlens.shape[0], rlens.device


def decode_plain(rects, rlens, f1, f2, signals, subws, *, max_len: int,
                 lmax: int, pos0=None):
    """K4, C plain Huffman channels of N entries.

    rects: C (N, K_c) i32 rectangles (K_c may differ); rlens (N,) i32;
    f1 (C, 256) i32 L1 tables; f2 flat i32 L2; signals: C escape symbols
    (255 for a type-2 scheme, else 256); subws: C L2 row widths (0: L1
    only); pos0: optional (C, N) i32 starting bit offsets.  Each chain
    decodes min(rlen, max_len) symbols.  Returns (syms (C, N, max_len) u8,
    zero past each chain, bits (C, N) i32, last (C, N) i32)."""
    n, dev = _check_rlens(rlens)
    c = len(rects)
    if not 1 <= c <= MAX_CHANNELS or len(signals) != c or len(subws) != c:
        raise ValueError(f"decode_plain takes 1 to {MAX_CHANNELS} channels, each "
                         "with a signal and a subw")
    for i, r in enumerate(rects):
        _check_rect(f"rects[{i}]", r, n, dev)
    _check("f1", f1, torch.int32, (c, 256), dev)
    _check_l2(f2, lmax, subws, dev)
    if pos0 is not None:
        _check("pos0", pos0, torch.int32, (c, n), dev)
    if max_len < 0:
        raise ValueError("max_len must be >= 0")
    if not _route(rlens):
        return d2.plain_chains(rects, rlens, f1, f2, signals, subws,
                               max_len=max_len, lmax=lmax, pos0=pos0)
    syms = torch.empty((c, n, max_len), dtype=torch.uint8, device=dev)
    bits = torch.empty((c, n), dtype=torch.int32, device=dev)
    last = torch.empty((c, n), dtype=torch.int32, device=dev)
    if n:
        ptrs = (ctypes.c_void_p * c)(*(r.data_ptr() for r in rects))
        ks = (ctypes.c_longlong * c)(*(r.shape[1] for r in rects))
        sig = (ctypes.c_int * c)(*(int(s) for s in signals))
        sws = (ctypes.c_int * c)(*(int(s) for s in subws))
        _launch("decode_plain", dispatch.kernels().dxt_decode_plain, c,
                ctypes.addressof(ptrs), ctypes.addressof(ks),
                ctypes.addressof(sig), ctypes.addressof(sws), rlens, pos0, f1,
                f2, f2.numel(), lmax, syms, bits, last, n, max_len)
    return syms, bits, last


def decode_run(rect, rlens, f1r, f1s, f2, nsignal: int, *, max_tokens: int,
               subw: int, lmax: int, pos0=None, carry=None):
    """K5, one RLE channel of N entries as (runlen, literal) tokens.

    rect (N, K) i32; rlens (N,) i32; f1r/f1s (256,) i32 L1 tables of the
    run and the symbol scheme; f2 flat i32 L2; nsignal the symbol scheme's
    escape (255 or 256); pos0/carry optional (N,) i32 checkpoint resume
    (carry >= 0: token 0 is (carry, literal at pos0)).  Returns (runs
    (N, max_tokens) i32, lits (N, max_tokens) i32 with -1 where no literal,
    bits (N,) i32, last (N,) i32); padding tokens are (0, -1)."""
    n, dev = _check_rlens(rlens)
    _check_rect("rect", rect, n, dev)
    _check("f1r", f1r, torch.int32, (256,), dev)
    _check("f1s", f1s, torch.int32, (256,), dev)
    _check_l2(f2, lmax, [subw], dev)
    for name, x in (("pos0", pos0), ("carry", carry)):
        if x is not None:
            _check(name, x, torch.int32, (n,), dev)
    if max_tokens < 0:
        raise ValueError("max_tokens must be >= 0")
    if not _route(rlens):
        return d2.run_chain(rect, rlens, f1r, f1s, f2, int(nsignal),
                            max_tokens=max_tokens, subw=subw, lmax=lmax,
                            pos0=pos0, carry=carry)
    runs = torch.empty((n, max_tokens), dtype=torch.int32, device=dev)
    lits = torch.empty((n, max_tokens), dtype=torch.int32, device=dev)
    bits = torch.empty((n,), dtype=torch.int32, device=dev)
    last = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _launch("decode_run", dispatch.kernels().dxt_decode_run, rect, rect.shape[1],
                rlens, pos0, carry, f1r, f1s, f2, f2.numel(), subw, lmax,
                int(nsignal), runs, lits, bits, last, n, max_tokens)
    return runs, lits, bits, last
