"""Huffman schemes of the .dexqv coding, byte-identical to DEXTRACTOR's QV.c.

A frozen copy of the reference's scheme build (``Huffman``, ``Build_Table``,
``Reheap``, QV.c:91-220) and of ``Write_Scheme`` (QV.c:300-330), in plain
Python and NumPy.  The code lengths depend on the reference's array-heap
tie-breaking, so the steps are kept as the C code takes them: the escape
pseudo-symbol first when truncating, then symbols ascending, the same sift,
merge order and depth-first code assignment (left 0, right 1).

Types (QV.c:77-81): 0, every code at most 16 bits; 1, some longer (an
intermediate result); 2, truncated: the long-coded symbols and symbol 255
share one escape code, followed by an 8-bit literal (16 bits in a run
scheme).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HUFF_CUTOFF = 16


@dataclass
class Scheme:
    type: int
    codelens: np.ndarray    # (256,) int32
    codebits: np.ndarray    # (256,) uint32


def _reheap(s: int, heap: list[int], hsize: int, count: list[int]) -> None:
    c = s
    hs = heap[s]
    while (l := 2 * c) <= hsize:
        r = l + 1
        hl = heap[l]
        if r > hsize or count[heap[r]] > count[hl]:
            if count[hs] > count[hl]:
                heap[c] = hl
                c = l
            else:
                break
        else:
            hr = heap[r]
            if count[hs] > count[hr]:
                heap[c] = hr
                c = r
            else:
                break
    if c != s:
        heap[c] = hs


def _huffman(hist: np.ndarray, inscheme: Scheme | None) -> Scheme:
    count: list[int] = []
    sym: list[int] = []
    lft: list[int] = []
    rgt: list[int] = []

    def node(c, s, lc=-1, rc=-1):
        count.append(c)
        sym.append(s)
        lft.append(lc)
        rgt.append(rc)
        return len(count) - 1

    heap = [0] * 259                      # 1-based
    hsize = 0
    if inscheme is not None:
        hsize += 1
        heap[hsize] = node(0, 255)
    for i in range(256):
        if hist[i] > 0:
            if inscheme is not None and (inscheme.codelens[i] > HUFF_CUTOFF or i == 255):
                count[0] += int(hist[i])
            else:
                hsize += 1
                heap[hsize] = node(int(hist[i]), i)
    value = len(count)
    if value == 0:
        raise ValueError("a Huffman scheme over an empty histogram")
    for i in range(hsize // 2, 0, -1):
        _reheap(i, heap, hsize, count)
    for _ in range(1, value):
        a = heap[1]
        heap[1] = heap[hsize]
        hsize -= 1
        _reheap(1, heap, hsize, count)
        b = heap[1]
        heap[1] = node(count[a] + count[b], -1, a, b)
        _reheap(1, heap, hsize, count)

    codebits = np.zeros(256, np.uint32)
    codelens = np.zeros(256, np.int32)
    stack = [(len(count) - 1, 0, 0)]
    while stack:
        nd, code, ln = stack.pop()
        if rgt[nd] < 0:
            codebits[sym[nd]] = code
            codelens[sym[nd]] = ln
        else:
            stack.append((rgt[nd], (code << 1) + 1, ln + 1))
            stack.append((lft[nd], code << 1, ln + 1))

    if inscheme is not None:
        for i in range(255):
            if inscheme.codelens[i] > HUFF_CUTOFF or codelens[i] > HUFF_CUTOFF:
                codelens[i] = codelens[255]
                codebits[i] = codebits[255]
        return Scheme(2, codelens, codebits)
    return Scheme(1 if (codelens > HUFF_CUTOFF).any() else 0, codelens, codebits)


def make_scheme(hist: np.ndarray) -> Scheme:
    """SCHEME_MACRO (QV.c:1069-1078): a second, truncating pass when the
    first gives a code longer than 16 bits."""
    scheme = _huffman(hist, None)
    if scheme.type:
        scheme = _huffman(hist, scheme)
    return scheme


def scheme_bytes(scheme: Scheme) -> bytes:
    """Write_Scheme: the type byte, then per symbol its length byte and,
    where the length is not 0, its code as a little-endian u32."""
    out = bytearray([scheme.type & 0xFF])
    for i in range(256):
        ln = int(scheme.codelens[i])
        out.append(ln & 0xFF)
        if ln > 0:
            out += int(scheme.codebits[i]).to_bytes(4, "little")
    return bytes(out)
