"""The delTag route by kept rank: the wrapper of the CUDA kernel K10
(ops/csrc/tag.cu), its plain PyTorch twin, and the prep of its inputs
(``dextractor_tpu/ops/tag_pallas.py`` and the tag phase of the JAX
package's ``tools/decode_ablate.py``).

Unpack_Tag (QV.c:824-847) puts the r-th packed 2-bit delTag code of a read
at its r-th kept position (delQV != delChar) and 'n' at the other positions
of the read.  ``tag_state`` fuses what a position needs into one int32,
``rank << 2 | kept << 1 | in_read``; ``tag_words`` packs the tag bytes into
little-endian u32 words; ``tag_route_rows`` (K10) gathers, for every
position, code ``rank`` from word ``rank >> 4``.  The main decode path
places the letters inside K6 instead (ops/expand.py); K10's path is the
decode step's phase split (tools/decode_ablate.py), and CPU tests hold its
output to the TAG rows of the full decode.

As the other wrappers, ``tag_route_rows`` checks device, dtype, shape and
contiguity, allocates its output, launches on
``torch.cuda.current_stream()``, raises on a non-zero ``cudaError_t`` and
counts the launch in ``utils.dispatch.LAUNCHES``.  A tensor on the CPU goes
to the twin; a tensor on a CUDA device goes to the kernel or the wrapper
raises: nothing falls back.
"""

from __future__ import annotations

import torch

from ..utils import dispatch
from .emit import _check, _launch, _route

_MAX_ROWS = (1 << 31) - 1     # rows are the grid's x dimension
_MAX_WIDTH = 65535 * 512      # 512-column blocks are its y dimension
_LETTERS = b"acgt"


def tag_state(del_rows, rlens, del_char: int):
    """(N, L) u8 delQV rows, (N,) int read lengths, the delChar -> (N, L)
    int32 ``max(rank, 0) << 2 | kept << 1 | in_read``, where in_read is
    column < rlen, kept is in_read with delQV != delChar and rank is the
    running count of kept positions minus one."""
    n, l = del_rows.shape
    in_read = torch.arange(l, device=del_rows.device)[None, :] < rlens[:, None]
    keep = in_read & (del_rows != (del_char & 0xFF))
    rank = torch.cumsum(keep.to(torch.int32), 1, dtype=torch.int32) - 1
    return ((rank.clamp_min(0) << 2) | (keep.to(torch.int32) << 1)
            | in_read.to(torch.int32))


def tag_words(tag_bytes):
    """(N, TB) u8 packed tag bytes -> (N, TB // 4) int32 holding the u32
    little-endian words of each row's bytes (a tail of TB % 4 bytes is
    dropped, as the JAX package's prep drops it)."""
    n, tb = tag_bytes.shape
    b = tag_bytes[:, :tb - tb % 4].reshape(n, tb // 4, 4).to(torch.int32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def tag_route_rows(tag_words, state, *, max_len: int):
    """K10: (N, TBW) int32 tag words (u32 bit patterns) and (N, max_len)
    int32 state -> (N, max_len) u8 rows: 'a/c/g/t' at kept positions (code
    ``rank``, first code of a byte in bits 7-6), 'n' at in-read holes, 0
    past the read.  A word index outside [0, TBW) reads as 0 ('a')."""
    if not isinstance(tag_words, torch.Tensor) or tag_words.dim() != 2:
        raise ValueError("tag_words: expected an (N, TBW) tensor")
    n, tbw = tag_words.shape
    dev = tag_words.device
    if max_len < 0:
        raise ValueError("max_len must be >= 0")
    _check("tag_words", tag_words, torch.int32, (n, tbw), dev)
    _check("state", state, torch.int32, (n, max_len), dev)
    if not _route(state):
        return tag_route_rows_ref(tag_words, state, max_len=max_len)
    if n > _MAX_ROWS or max_len > _MAX_WIDTH:
        raise ValueError(f"{n} rows of width {max_len}: the kernel takes at most "
                         f"{_MAX_ROWS} rows of at most {_MAX_WIDTH} columns")
    out = torch.empty((n, max_len), dtype=torch.uint8, device=dev)
    if n and max_len:
        vec = max_len % 4 == 0 and state.data_ptr() % 16 == 0
        _launch("tag_route", dispatch.kernels().dxt_tag_route, tag_words, tbw, state,
                out, n, max_len, int(vec))
    return out


def tag_route_rows_ref(tag_words, state, *, max_len: int):
    """The plain twin of K10, with ``tag_route_rows``' signature."""
    dispatch.TWIN_CALLS["tag_route"] += 1
    n, tbw = tag_words.shape
    rank = state >> 2
    widx = rank >> 4
    if tbw:
        word = torch.gather(tag_words, 1, widx.clamp(0, tbw - 1).long())
        word = torch.where((widx >= 0) & (widx < tbw), word, 0)
    else:
        word = torch.zeros_like(state)
    byte = (word >> (8 * ((rank >> 2) & 3))) & 0xFF
    code = (byte >> (6 - 2 * (rank & 3))) & 3
    letters = torch.tensor(list(_LETTERS), dtype=torch.int32, device=state.device)
    out = torch.where((state & 2) != 0, letters[code.long()],
                      torch.where((state & 1) != 0, ord("n"), 0))
    return out.to(torch.uint8)
