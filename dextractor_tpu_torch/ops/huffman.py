"""Huffman scheme construction, byte-identical to the reference.

The port's own copy of ``dextractor_tpu/ops/huffman.py``: scheme build and
serialise, and the decode side (``parse_scheme``, the 64K peek table).  The
encoded bitstream depends on the exact shape of the Huffman
tree, which depends on the reference's array-heap tie-breaking
(QV.c:91-220), so the algorithm is kept step for step: the same heap load
order (escape pseudo-symbol first when truncating, then symbols ascending),
the same ``Reheap`` sift, merge order and DFS code assignment (left=0,
right=1).

Schemes come in three types (QV.c:77-81): 0, all code lengths <= 16; 1, some
length > 16 (an intermediate result only); 2, truncated: all long-coded
symbols plus symbol 255 share one escape code, followed by an 8-bit literal
(a 16-bit literal run length in RLE schemes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.errors import FormatError

HUFF_CUTOFF = 16  # QV.c:26 — must not exceed 16


@dataclass
class HScheme:
    type: int
    codelens: np.ndarray                 # (256,) int32
    codebits: np.ndarray                 # (256,) uint32
    lookup: np.ndarray | None = None     # (65536,) int32 — decode side only

    def with_lookup(self) -> "HScheme":
        if self.lookup is None:
            self.lookup = build_lookup(self.codelens, self.codebits)
        return self


def build_lookup(codelens: np.ndarray, codebits: np.ndarray) -> np.ndarray:
    """64K-entry peek table: top-16-bit window -> symbol (QV.c:365-372)."""
    look = np.zeros(0x10000, np.int32)
    for i in range(256):
        l = int(codelens[i])
        if l > 0:
            base = int(codebits[i]) << (16 - l)
            look[base: base + (1 << (16 - l))] = i
    return look


def _reheap(s: int, heap: list[int], hsize: int, count: list[int]) -> None:
    """Sift-down with the reference's exact comparison order (QV.c:91-120)."""
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


def build_huffman(hist: np.ndarray, inscheme: HScheme | None) -> HScheme:
    """One Huffman pass (reference ``Huffman`` QV.c:147-220).

    With ``inscheme``, all symbols coded longer than HUFF_CUTOFF by it —
    plus symbol 255 — are merged into a single escape class whose code is
    the one assigned to 255.
    """
    count: list[int] = []
    sym: list[int] = []
    lft: list[int] = []
    rgt: list[int] = []

    def new_node(c, s, lc=-1, rc=-1):
        count.append(c)
        sym.append(s)
        lft.append(lc)
        rgt.append(rc)
        return len(count) - 1

    heap: list[int] = [0] * 259  # 1-based
    hsize = 0
    if inscheme is not None:
        esc = new_node(0, 255)
        hsize += 1
        heap[hsize] = esc
    for i in range(256):
        if hist[i] > 0:
            if inscheme is not None and (inscheme.codelens[i] > HUFF_CUTOFF or i == 255):
                count[0] += int(hist[i])
            else:
                n = new_node(int(hist[i]), i)
                hsize += 1
                heap[hsize] = n

    value = len(count)
    if value == 0:
        raise FormatError("cannot build a Huffman scheme over an empty histogram")

    for i in range(hsize // 2, 0, -1):
        _reheap(i, heap, hsize, count)

    for _ in range(1, value):
        a = heap[1]
        heap[1] = heap[hsize]
        hsize -= 1
        _reheap(1, heap, hsize, count)
        b = heap[1]
        m = new_node(count[a] + count[b], -1, a, b)
        heap[1] = m
        _reheap(1, heap, hsize, count)

    codebits = np.zeros(256, np.uint32)
    codelens = np.zeros(256, np.int32)

    # iterative DFS replicating Build_Table's recursion (QV.c:125-137)
    stack = [(len(count) - 1, 0, 0)]
    while stack:
        node, code, ln = stack.pop()
        if rgt[node] < 0:
            codebits[sym[node]] = code
            codelens[sym[node]] = ln
        else:
            stack.append((rgt[node], (code << 1) + 1, ln + 1))
            stack.append((lft[node], code << 1, ln + 1))

    if inscheme is not None:
        scheme_type = 2
        for i in range(255):
            if inscheme.codelens[i] > HUFF_CUTOFF or codelens[i] > HUFF_CUTOFF:
                codelens[i] = codelens[255]
                codebits[i] = codebits[255]
    else:
        scheme_type = 1 if (codelens > HUFF_CUTOFF).any() else 0

    return HScheme(scheme_type, codelens, codebits)


def make_scheme(hist: np.ndarray) -> HScheme:
    """The two-pass recipe of SCHEME_MACRO (QV.c:1069-1078)."""
    scheme = build_huffman(hist, None)
    if scheme.type:
        scheme = build_huffman(hist, scheme)
    return scheme


def scheme_bytes(scheme: HScheme) -> bytes:
    """Write_Scheme (QV.c:300-330): type byte, then 256 x (len byte
    [+ 4-byte code if len > 0])."""
    out = bytearray([scheme.type & 0xFF])
    lens = scheme.codelens
    bits = scheme.codebits
    for i in range(256):
        l = int(lens[i])
        out.append(l & 0xFF)
        if l > 0:
            out += int(bits[i]).to_bytes(4, "little")
    return bytes(out)


def parse_scheme(buf: memoryview, off: int, flip: bool = False) -> tuple[HScheme, int]:
    """Read_Scheme (QV.c:333-375): the inverse of ``scheme_bytes``; a
    flipped (big-endian) file stores each code big-endian.  Returns the
    scheme, with its peek table built, and the offset past it."""
    if off >= len(buf):
        raise FormatError("could not read scheme type byte")
    stype = buf[off]
    off += 1
    codelens = np.zeros(256, np.int32)
    codebits = np.zeros(256, np.uint32)
    for i in range(256):
        if off >= len(buf):
            raise FormatError(f"could not read length of {i}'th code")
        l = buf[off]
        off += 1
        codelens[i] = l
        if l > 0:
            if off + 4 > len(buf):
                raise FormatError(f"could not read bit encoding of {i}'th code")
            codebits[i] = int.from_bytes(buf[off:off + 4], "big" if flip else "little")
            off += 4
    scheme = HScheme(int(stype), codelens, codebits)
    scheme.with_lookup()
    return scheme, off
