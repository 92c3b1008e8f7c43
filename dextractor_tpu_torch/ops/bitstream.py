"""The host walker's Huffman stream decode (``dextractor_tpu/ops/bitstream.py``,
its decode half).

The port's own copy of ``BitReader``, ``_stream_words``, ``decode_stream``
and ``decode_run_stream``: one stream at a time, symbol by symbol, as the
reference's ``Decode``/``Decode_Run`` (QV.c:510-691) read it.  It is the
decoder of a container written on a host of the other byte order
(``coding.flip``): its stream words are byte-swapped, which ``BitReader``
undoes word by word.  The native walker and the device chains read
little-endian words only, so ``codecs/qv_codec.decode_dexqv_to_quiva``
routes every flipped container here, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from .huffman import HScheme


class BitReader:
    """Absolute-bit-position reader over the container bytes.

    Equivalent to the reference's 64-bit window + on-demand 32-bit refills
    (QV.c:537-568): both consume exactly the words the encoder wrote, so
    after a stream is drained, ``words_consumed`` gives the next stream's
    byte offset via the encoder's padding formula.
    """

    def __init__(self, buf: np.ndarray, byte_off: int, flip: bool = False):
        self.buf = buf
        self.base = byte_off
        self.pos = 0           # bit position within the stream
        self.flip = flip

    def peek16(self) -> int:
        bit = self.pos
        byte = self.base + (bit >> 5) * 4
        word0 = self._word(byte)
        word1 = self._word(byte + 4)
        window = (word0 << 32) | word1
        return (window >> (48 - (bit & 31))) & 0xFFFF

    def _word(self, byte: int) -> int:
        b = self.buf[byte: byte + 4]
        if len(b) < 4:
            b = np.concatenate([b, np.zeros(4 - len(b), np.uint8)])
        # words are native little-endian u32 on disk; 'flip' marks a stream
        # written by an opposite-endian machine
        return int.from_bytes(b.tobytes(), "big" if self.flip else "little")

    def skip(self, n: int) -> None:
        self.pos += n

    def take(self, n: int) -> int:
        v = (self.peek16() >> (16 - n)) & ((1 << n) - 1)
        self.pos += n
        return v


def _stream_words(total_bits: int, last_bits: int) -> int:
    """Words the encoder wrote for a stream of ``total_bits`` whose final
    emission was ``last_bits`` wide (the padding rule, QV.c:436-442)."""
    if total_bits == 0:
        return 0
    nfull = total_bits >> 5
    olen = total_bits & 31
    llen = (total_bits - last_bits) & 31
    if olen > 0:
        return nfull + (2 if (llen > 16 and olen > llen) else 1)
    return nfull + (1 if llen > 16 else 0)


def decode_stream(scheme: HScheme, reader: BitReader, rlen: int) -> tuple[np.ndarray, int]:
    """Decode ``rlen`` symbols; returns (symbols, words_consumed)."""
    scheme.with_lookup()
    look = scheme.lookup
    lens = scheme.codelens
    signal = 255 if scheme.type == 2 else 256
    out = np.empty(rlen, np.uint8)
    last = 0
    for j in range(rlen):
        c = int(look[reader.peek16()])
        n = int(lens[c])
        reader.skip(n)
        last = n
        if c == signal:
            c = reader.take(8)
            last = 8
        out[j] = c
    words = _stream_words(reader.pos, last)
    return out, words


def decode_run_stream(neme: HScheme, reme: HScheme, reader: BitReader,
                      rlen: int, rchar: int) -> tuple[np.ndarray, int]:
    """Decode an RLE stream of ``rlen`` expanded symbols."""
    neme.with_lookup()
    reme.with_lookup()
    nlook, nlens = neme.lookup, neme.codelens
    rlook, rlens = reme.lookup, reme.codelens
    nsignal = 255 if neme.type == 2 else 256
    out = np.empty(rlen, np.uint8)
    j = 0
    last = 0
    while j < rlen:
        c = int(rlook[reader.peek16()])
        n = int(rlens[c])
        reader.skip(n)
        last = n
        if c == 255:
            c = reader.take(16)
            last = 16
        out[j: j + c] = rchar
        j += c
        if j < rlen:
            s = int(nlook[reader.peek16()])
            n = int(nlens[s])
            reader.skip(n)
            last = n
            if s == nsignal:
                s = reader.take(8)
                last = 8
            out[j] = s
            j += 1
    words = _stream_words(reader.pos, last)
    return out, words
