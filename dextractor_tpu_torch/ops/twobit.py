"""2-bit base packing: the alphabet tables and the plain PyTorch twins of
the 2-bit kernels (``dextractor_tpu/ops/twobit.py``).

The reference packs 4 numeric bases per byte, first base in the two *high*
bits (reference DB.c:319-363, ``COMPRESSED_LEN`` DB.h:255).  Bases beyond a
read's length inside the final byte pack as zero (the C code zeroes the three
bytes past the end before its 4-stride loop, DB.c:329-331).

The alphabet tables are constants copied byte for byte from the JAX
package's, quirks included (``Number_Arrow`` maps 'G'->2 in addition to
'1','2','3'->0,1,2 with a default of 3, reference DB.c:418-441); a CPU test
holds each against its original.

``unpack_2bit_np`` unpacks the delTag bytes of the host walker
(``codecs/qv_codec.decode_entry``).

``pack2bit_twin`` and ``unpack2bit_twin`` are the plain versions of the CUDA
kernels ``dxt_pack2bit`` (K7) and ``dxt_unpack2bit`` (ops/pack2bit.py): the
wrappers run them for tensors on the CPU, and ``chip_smoke.py`` holds each
kernel against its twin on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import dispatch


def compressed_len(rlen):
    """Bytes for a 2-bit packed read: (len+3)>>2 (reference DB.h:255)."""
    return (rlen + 3) >> 2


# ---------------------------------------------------------------------------
# Alphabet translation tables (reference DB.c:367-465)
# ---------------------------------------------------------------------------

def _number_base_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)           # unknown chars -> 0 ('a')
    for i, ch in enumerate(b"acgt"):
        t[ch] = i
        t[ch - 32] = i                     # uppercase
    return t


def _number_arrow_table() -> np.ndarray:
    t = np.full(256, 3, np.uint8)          # default 3 (covers '4')
    t[ord("1")] = 0
    t[ord("2")] = 1
    t[ord("3")] = 2
    t[ord("G")] = 2                        # reference quirk, DB.c:428
    return t


NUMBER_BASE_LUT = _number_base_table()
NUMBER_ARROW_LUT = _number_arrow_table()
LOWER_LUT = np.frombuffer(b"acgt", np.uint8).copy()
UPPER_LUT = np.frombuffer(b"ACGT", np.uint8).copy()
ARROW_LETTER_LUT = np.frombuffer(b"1234", np.uint8).copy()


def pack_2bit_np(codes: np.ndarray, lengths: np.ndarray | None = None) -> np.ndarray:
    """Pack (N, L) numeric codes (values 0..3) into (N, L//4) bytes, the
    first code in bits 7-6; L must be a multiple of 4.  With ``lengths``
    (N,), positions at or past a row's length pack as 0 (they may hold
    padding garbage)."""
    n, l = codes.shape
    if l % 4:
        raise ValueError("pad L to a multiple of 4")
    if lengths is not None:
        col = np.arange(l, dtype=np.int64)
        codes = np.where(col[None, :] < np.asarray(lengths)[:, None], codes, 0)
    quads = codes.reshape(n, l // 4, 4).astype(np.uint8)
    return (
        (quads[..., 0] << 6) | (quads[..., 1] << 4) | (quads[..., 2] << 2) | quads[..., 3]
    )


def unpack_2bit_np(packed: np.ndarray) -> np.ndarray:
    """Unpack (N, C) bytes into (N, 4*C) numeric codes 0..3."""
    n, c = packed.shape
    out = np.empty((n, c, 4), np.uint8)
    out[..., 0] = packed >> 6
    out[..., 1] = (packed >> 4) & 3
    out[..., 2] = (packed >> 2) & 3
    out[..., 3] = packed & 3
    return out.reshape(n, 4 * c)


# ---------------------------------------------------------------------------
# plain PyTorch twins of the 2-bit kernels
# ---------------------------------------------------------------------------

def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def pack2bit_twin(rows_or_flat: torch.Tensor, lengths: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """Number_Read + Compress_Read: ``lut[x]``, codes at or past a read's
    length zeroed, four codes a byte with the first in bits 7-6.

    rows (N, L) u8 ascii -> (N, ceil(L/4)) u8; or flat (T,) u8, the reads
    end to end with lengths (N,) -> (sum ceil(len/4),) u8, the reads'
    payloads end to end.  ``lut`` is (256,) u8 with values 0..3."""
    dispatch.TWIN_CALLS["pack2bit"] += 1
    x = rows_or_flat
    dev = x.device
    lengths = lengths.to(torch.int64)
    lut = lut.to(torch.int32)
    if x.dim() == 2:
        n, l = x.shape
        col = torch.arange(l, device=dev)
        codes = torch.where(col < lengths[:, None], lut[x.long()], 0)
        codes = torch.nn.functional.pad(codes, (0, (-l) % 4)).reshape(n, -1, 4)
    else:
        clens = compressed_len(lengths)
        n_out = int(clens.sum())
        if n_out == 0:
            return torch.zeros(0, dtype=torch.uint8, device=dev)
        read = torch.repeat_interleave(torch.arange(len(lengths), device=dev), clens,
                                       output_size=n_out)
        quad = torch.arange(n_out, device=dev) - _exclusive_cumsum(clens)[read]
        pos = 4 * quad[:, None] + torch.arange(4, device=dev)
        valid = pos < lengths[read][:, None]
        idx = (_exclusive_cumsum(lengths)[read][:, None] + pos).clamp_(max=x.numel() - 1)
        codes = torch.where(valid, lut[x[idx].long()], 0)
    packed = (codes[..., 0] << 6) | (codes[..., 1] << 4) | (codes[..., 2] << 2) | codes[..., 3]
    return packed.to(torch.uint8)


def unpack2bit_twin(packed: torch.Tensor, lengths: torch.Tensor | None,
                    letter_lut: torch.Tensor) -> torch.Tensor:
    """Uncompress_Read + the letter map: code c -> ``letter_lut[c]``.

    packed (N, C) u8 with lengths None -> (N, 4C) u8, every code of every
    byte (``twobit.unpack_translate``); or flat (P,) u8, the payloads of
    reads of lengths (N,) end to end (ceil(len/4) bytes each) ->
    (sum len,) u8, exactly len letters per read.  ``letter_lut`` is (4,)
    u8."""
    dispatch.TWIN_CALLS["unpack2bit"] += 1
    dev = packed.device
    letters = letter_lut.to(torch.uint8)
    if packed.dim() == 2:
        if lengths is not None:
            raise ValueError("a packed rectangle unpacks whole: pass lengths=None")
        shifts = torch.tensor([6, 4, 2, 0], dtype=torch.int32, device=dev)
        codes = (packed.to(torch.int32)[..., None] >> shifts) & 3
        return letters[codes.long()].reshape(packed.shape[0], -1)
    rlens = lengths.to(torch.int64)
    total = int(rlens.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    read = torch.repeat_interleave(torch.arange(len(rlens), device=dev), rlens,
                                   output_size=total)
    j = torch.arange(total, device=dev) - _exclusive_cumsum(rlens)[read]
    byte = packed[_exclusive_cumsum(compressed_len(rlens))[read] + (j >> 2)]
    codes = (byte.to(torch.int64) >> (6 - 2 * (j & 3))) & 3
    return letters[codes]
