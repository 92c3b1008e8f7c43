"""Wrapper of the CUDA run-expansion kernel K6 (ops/csrc/decode.cu).

``expand_runs`` turns (runlen, literal) token planes into symbol rows and,
given the packed delTag bytes, places the delTag letter of every literal
beside it in the same pass (the JAX package's ``decode2.expand_del_tag``).
The kernel gives each row a warp (8 warps where the rows are fewer than 4
an SM or have more than 1,024 tokens, 32 past 4,096 tokens), each warp a
slice of the row's tokens: token k owns
the columns [cumsum(runs)[k-1] + k, cumsum(runs)[k] + k], so a warp builds
its slice's span of columns in shared memory and writes each column once.
That takes runs >= 0, which every producer gives (K5's tokens,
``tools/decode_ablate.expand_tokens``).  The wrapper checks its arguments,
allocates its outputs, launches on ``torch.cuda.current_stream()``, raises
on a non-zero ``cudaError_t`` and counts the launch in
``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes
to the plain twin in ops/decode2.py; nothing falls back.
"""

from __future__ import annotations

import torch

from ..utils import dispatch
from . import decode2 as d2
from .emit import _check, _launch, _route

_MAX_ROWS = (1 << 31) - 1
_MAX_COLS = 1 << 30   # max_len and tokens a row: the kernel's column sums stop there


def expand_runs(runs, lits, rchar: int, *, max_len: int, tag_bytes=None):
    """K6: literal k of a row goes to column cumsum(runs)[k] + k, ``rchar``
    fills every other column, columns >= max_len are dropped, and only
    tokens with lits >= 0 are placed.

    runs/lits (N, T) i32, runs >= 0, T and max_len at most 2^30; rchar an
    int (its low byte is written); tag_bytes
    optional (N, TB) u8 packed 2-bit delTag codes, code k of a row being the
    tag of its literal k (first code in bits 7-6; codes past 4*TB read 0).
    Returns (rows (N, max_len) u8, tags (N, max_len) i8 or None): the tag
    letter 'a/c/g/t' under every literal and -1 at the holes."""
    if not isinstance(runs, torch.Tensor) or runs.dim() != 2:
        raise ValueError("runs: expected an (N, T) tensor")
    n, t = runs.shape
    dev = runs.device
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows: the kernel takes at most {_MAX_ROWS}")
    _check("runs", runs, torch.int32, (n, t), dev)
    _check("lits", lits, torch.int32, (n, t), dev)
    if tag_bytes is not None:
        if not isinstance(tag_bytes, torch.Tensor) or tag_bytes.dim() != 2:
            raise ValueError("tag_bytes: expected an (N, TB) tensor")
        _check("tag_bytes", tag_bytes, torch.uint8, (n, tag_bytes.shape[1]), dev)
    if not 0 <= max_len <= _MAX_COLS or t > _MAX_COLS:
        raise ValueError(f"max_len {max_len} and {t} tokens a row: the kernel takes 0 to "
                         f"{_MAX_COLS}")
    rchar = int(rchar)
    if not _route(runs):
        return expand_runs_ref(runs, lits, rchar, max_len=max_len, tag_bytes=tag_bytes)
    rows = torch.empty((n, max_len), dtype=torch.uint8, device=dev)
    tags = (None if tag_bytes is None
            else torch.empty((n, max_len), dtype=torch.int8, device=dev))
    if n:
        _launch("expand_runs", dispatch.kernels().dxt_expand_runs, runs, lits, t,
                rchar, tag_bytes, 0 if tag_bytes is None else tag_bytes.shape[1],
                rows, tags, n, max_len)
    return rows, tags


def expand_runs_ref(runs, lits, rchar: int, *, max_len: int, tag_bytes=None):
    """The plain twin of K6 with ``expand_runs``' signature and outputs."""
    if tag_bytes is None:
        return d2.expand_runs2(runs, lits, rchar, max_len=max_len), None
    return d2.expand_del_tag(runs, lits, d2._unpack_tag_codes(tag_bytes, runs.shape[1]),
                             rchar, max_len=max_len)
