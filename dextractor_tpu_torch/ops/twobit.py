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
(``codecs/qv_codec.decode_entry``); ``change_read`` and ``print_read`` are
the reference's Change_Read and Print_Read on the host.

``pack2bit_twin`` and ``unpack2bit_twin`` are the plain versions of the CUDA
kernels ``dxt_pack2bit`` (K7) and ``dxt_unpack2bit`` (ops/pack2bit.py): the
wrappers run them for tensors on the CPU, and ``chip_smoke.py`` holds each
kernel against its twin on the card.

The device ops of the JAX package's module run on those kernels, on
rectangles of reads (row i of an (N, L) rectangle is read i, at offset i*L
of the flat buffer the kernels take): ``pack_translate`` and ``pack_2bit``
on K7, ``unpack_translate`` and ``unpack_2bit`` on the unpack, and
``translate`` on K9 (ops/lut.py).  Each runs where its tensor lies (a CUDA
tensor goes to the kernel, a CPU one to the twin); a NumPy array goes to
the card, and raises where there is none.
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
ALPHABET_LUTS = {"base": NUMBER_BASE_LUT, "arrow": NUMBER_ARROW_LUT}


def _change_case_table() -> np.ndarray:
    """acgt <-> ACGT case toggle (reference Change_Read, DB.c:443-465)."""
    t = np.zeros(256, np.uint8)
    for ch in b"acgt":
        t[ch] = ch - 32
        t[ch - 32] = ch
    return t


CHANGE_CASE_LUT = _change_case_table()


def change_read(seq: np.ndarray) -> np.ndarray:
    """Toggle sequence case (Change_Read)."""
    return CHANGE_CASE_LUT[seq]


def print_read(codes: np.ndarray, width: int = 80) -> bytes:
    """Numeric codes -> lowercase text wrapped at ``width``
    (reference Print_Read, DB.c:1164-1183)."""
    sym = LOWER_LUT[codes]
    out = []
    for i in range(0, len(sym), width):
        out.append(sym[i:i + width].tobytes())
    return b"\n".join(out) + b"\n" if out else b""


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


# ---------------------------------------------------------------------------
# the device ops: K7, the unpack and K9 on rectangles of reads
# ---------------------------------------------------------------------------

_IDENTITY_LUT = (np.arange(256) & 3).astype(np.uint8)


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, a NumPy array on ``device``
    (None: the card)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = dispatch.resolve_device(True) if device is None else device
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _host_lut(lut) -> np.ndarray:
    return np.asarray(lut.cpu() if isinstance(lut, torch.Tensor) else lut, np.uint8)


def pack_rows(rows, lengths, lut) -> torch.Tensor:
    """Number_Read + Compress_Read of a rectangle through one K7 launch:
    (N, L) u8 rows, lengths (N,) and a (256,) code table (its low two bits
    are kept) -> (N, ceil(L/4)) u8, first code in bits 7-6.  Rectangle row
    i is read i of L bases at offset i*L, its payload at i*ceil(L/4).  The
    bases at or past a row's length become a byte whose code is 0; with a
    table that has none, the rows are translated first and K7 packs them
    through the identity table."""
    rows = _tensor(rows)
    n, l = rows.shape
    dev = rows.device
    w = (l + 3) // 4
    lut = _host_lut(lut)
    inlen = torch.arange(l, device=dev)[None, :] < _tensor(lengths, dev).long()[:, None]
    zero = np.flatnonzero((lut & 3) == 0)
    if len(zero):
        flat = torch.where(inlen, rows, int(zero[0]))
        table = torch.from_numpy(lut).to(dev)
    else:
        flat = torch.where(inlen, torch.from_numpy(lut).to(dev)[rows.long()], 0)
        table = torch.from_numpy(_IDENTITY_LUT).to(dev)
    step = torch.arange(n + 1, device=dev, dtype=torch.int64)
    from .pack2bit import pack2bit

    return pack2bit(flat.reshape(-1).contiguous(), step * l, step * w, table,
                    n * w).reshape(n, w)


def pack_translate(rows, lengths, alphabet: str = "base") -> torch.Tensor:
    """Letter map + 2-bit pack: (N, L) ascii -> (N, ceil(L/4)) u8 through
    K7 (the JAX package's ``pack_translate``, which takes L a multiple of
    4).  alphabet "base": acgt/ACGT -> 0..3, anything else 0 (Number_Read,
    DB.c:367-416); "arrow": '1'..'4' -> 0..3, 'G' -> 2, anything else 3
    (Number_Arrow, DB.c:418-441).  Positions at or past a row's length pack
    as 0 (DB.c:329-331)."""
    if alphabet not in ALPHABET_LUTS:
        raise ValueError(f"unknown alphabet {alphabet!r}")
    return pack_rows(rows, lengths, ALPHABET_LUTS[alphabet])


def pack_2bit(codes, lengths=None, *, mask: bool = True) -> torch.Tensor:
    """2-bit pack of (N, L) u8 codes 0..3 -> (N, L//4) u8 through K7 and the
    identity table; L must be a multiple of 4.  With ``mask`` and
    ``lengths``, codes at or past a row's length pack as 0.  A code above 3
    packs as its low two bits (the JAX package's ``pack_2bit`` ORs it in
    whole, so its high bits land on the codes before it: ROADMAP F6);
    no caller makes one."""
    codes = _tensor(codes)
    n, l = codes.shape
    if l % 4:
        raise ValueError("pad L to a multiple of 4")
    if not (mask and lengths is not None):
        lengths = torch.full((n,), l, dtype=torch.int64, device=codes.device)
    return pack_rows(codes, lengths, _IDENTITY_LUT)


def unpack_translate(packed, lut) -> torch.Tensor:
    """Fused 2-bit unpack + letter map: (N, C) u8 -> (N, 4C) u8,
    ``lut[code]`` for every code of every byte (reference DB.c:342-363 +
    ``Lower/Upper_Read`` DB.c:367-416), through one launch of the unpack:
    rectangle row i is a read of 4C letters whose payload is at i*C.  Only
    the first four entries of ``lut`` are read."""
    from .pack2bit import unpack2bit

    packed = _tensor(packed)
    n, c = packed.shape
    dev = packed.device
    letters = torch.from_numpy(_host_lut(lut)[:4].copy()).to(dev)
    step = torch.arange(n + 1, device=dev, dtype=torch.int64)
    return unpack2bit(packed.reshape(-1).contiguous(), step * c, step * 4 * c, letters,
                      n * 4 * c).reshape(n, 4 * c)


def unpack_2bit(packed) -> torch.Tensor:
    """2-bit unpack of (N, C) u8 bytes -> (N, 4C) u8 codes 0..3, through the
    unpack with the letter table 0, 1, 2, 3."""
    return unpack_translate(packed, np.arange(4, dtype=np.uint8))


def translate(data, lut) -> torch.Tensor:
    """``lut[data]`` for a 256-entry table through one K9 launch
    (``lut.lut_gather``): data u8 or int32 of any shape, with values in
    [0, 256); the result has ``data``'s shape and ``lut``'s dtype (u8 for a
    NumPy table)."""
    from .lut import lut_gather

    data = _tensor(data).contiguous()
    table = _tensor(lut, data.device)
    out = lut_gather(data, table.to(device=data.device, dtype=torch.int32).contiguous())
    return out.to(table.dtype)
