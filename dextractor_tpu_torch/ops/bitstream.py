"""The host Huffman stream encode and decode (``dextractor_tpu/ops/bitstream.py``).

The port's own copy of the JAX package's NumPy bitstream engine.  The
encoders (``encode_stream``, ``encode_run_stream`` with ``tokenize_runs``,
``_scheme_emissions`` and ``_emit_words``) write the reference's 32-bit-word
MSB-first stream (``Encode``/``Encode_Run``, QV.c:386-506), tail-padding
rule included (QV.c:436-442); they are the per-entry encoder
(``codecs/qv_codec.encode_entry``) that runs when the native channel encoder
cannot build.  The decoders (``BitReader``, ``_stream_words``,
``decode_stream``, ``decode_run_stream``) read one stream at a time, symbol
by symbol, as the reference's ``Decode``/``Decode_Run`` (QV.c:510-691) do.
They decode a container written on a host of the other byte order
(``coding.flip``: ``BitReader`` undoes the byte swap word by word), and any
container when the native walker cannot build.

Known divergence (the JAX package's): run lengths >= 65536 overflow the
16-bit escape literal; the C encoder corrupts neighbouring bits, this one
clamps to the low 16 bits.  Both produce non-roundtrippable data.
"""
from __future__ import annotations

import numpy as np

from .huffman import HScheme


# ---------------------------------------------------------------------------
# tokenization
# ---------------------------------------------------------------------------

def _scheme_emissions(scheme: HScheme, data: np.ndarray):
    """Per-symbol emission (value, nbits) pairs plus last-emission length.

    An escaped symbol is modelled as one fused emission of
    (code << 8) | literal with nbits = codelen + 8 (the two OCODE calls of
    QV.c:427-434 back to back); ``lastbits`` still reports the final OCODE
    granularity (8 for an escape) because the tail-padding rule depends on it.
    """
    lens = scheme.codelens[data].astype(np.int64)
    bits = scheme.codebits[data].astype(np.uint64)
    if scheme.type == 2:
        nspec = np.uint32(scheme.codebits[255])
        nslen = int(scheme.codelens[255])
        esc = (scheme.codebits[data] == nspec) & (scheme.codelens[data] == nslen)
    else:
        esc = np.zeros(len(data), bool)
    v = np.where(esc, (bits << np.uint64(8)) | data.astype(np.uint64), bits)
    n = np.where(esc, lens + 8, lens)
    last = np.where(esc, 8, lens)
    return v, n, last


def _emit_words(values: np.ndarray, nbits: np.ndarray, lastbits: np.ndarray) -> np.ndarray:
    """Scatter emissions into u32 words and apply the tail-padding rule."""
    total = int(nbits.sum())
    if len(nbits) == 0:
        return np.empty(0, np.uint32)
    offs = np.zeros(len(nbits), np.int64)
    np.cumsum(nbits[:-1], out=offs[1:])

    nfull = total >> 5
    olen = total & 31
    words = np.zeros(nfull + 2, np.uint64)

    w = offs >> 5
    p = offs & 31
    chunk = values << (np.uint64(64) - (p + nbits).astype(np.uint64))
    np.bitwise_or.at(words, w, chunk >> np.uint64(32))
    np.bitwise_or.at(words, w + 1, chunk & np.uint64(0xFFFFFFFF))
    words = words.astype(np.uint32)

    llen = (total - int(lastbits[-1])) & 31
    out = words[:nfull]
    if olen > 0:
        partial = words[nfull:nfull + 1]
        if llen > 16 and olen > llen:
            return np.concatenate([out, partial, partial])
        return np.concatenate([out, partial])
    if llen > 16:
        return np.concatenate([out, np.zeros(1, np.uint32)])
    return out


def encode_stream(scheme: HScheme, data: np.ndarray) -> np.ndarray:
    """Encode one symbol stream (reference ``Encode`` QV.c:386-443) -> u32 words."""
    data = np.asarray(data, np.uint8)
    if len(data) == 0:
        return np.empty(0, np.uint32)
    v, n, last = _scheme_emissions(scheme, data)
    return _emit_words(v, n, last)


def tokenize_runs(data: np.ndarray, rchar: int):
    """Split ``data`` into (runlen, symbol) pairs per reference Encode_Run.

    Returns (runlens, symbols, has_symbol): one token per non-rchar symbol,
    carrying the length of the rchar run before it, plus a trailing
    symbol-less run token if the stream ends with rchar characters.
    """
    data = np.asarray(data, np.uint8)
    nonr = np.flatnonzero(data != rchar)
    k = len(nonr)
    trailing = len(data) - (int(nonr[-1]) + 1 if k else 0)
    n_tok = k + (1 if trailing > 0 else 0)
    runlens = np.empty(n_tok, np.int64)
    symbols = np.zeros(n_tok, np.uint8)
    has_symbol = np.zeros(n_tok, bool)
    if k:
        prev_end = np.concatenate([[-1], nonr[:-1]])
        runlens[:k] = nonr - prev_end - 1
        symbols[:k] = data[nonr]
        has_symbol[:k] = True
    if trailing > 0:
        runlens[-1] = trailing
    return runlens, symbols, has_symbol


def encode_run_stream(neme: HScheme, reme: HScheme, data: np.ndarray, rchar: int) -> np.ndarray:
    """Encode with RLE of ``rchar`` (reference ``Encode_Run`` QV.c:448-506)."""
    data = np.asarray(data, np.uint8)
    if len(data) == 0:
        return np.empty(0, np.uint32)
    runlens, symbols, has_symbol = tokenize_runs(data, rchar)

    # run-length emissions: the escape fires whenever a bucket's code equals
    # symbol 255's code — Encode_Run tests c == rspec unconditionally
    # (QV.c:468-469, 486-487), so in a type-2 run scheme every merged bucket
    # escapes, not just 255.  A 16-bit literal of the full length follows
    # (clamped, see module note).
    x = np.minimum(runlens, 255)
    rl = reme.codelens[x].astype(np.int64)
    rb = reme.codebits[x].astype(np.uint64)
    resc = (reme.codebits[x] == reme.codebits[255]) \
        & (reme.codelens[x] == reme.codelens[255])
    rv = np.where(resc, (rb << np.uint64(16)) | (runlens.astype(np.uint64) & np.uint64(0xFFFF)), rb)
    rn = np.where(resc, rl + 16, rl)
    rlast = np.where(resc, 16, rl)

    sv, sn, slast = _scheme_emissions(neme, symbols)
    sn = np.where(has_symbol, sn, 0)
    sv = np.where(has_symbol, sv, np.uint64(0))

    values = np.empty(2 * len(runlens), np.uint64)
    nbits = np.empty(2 * len(runlens), np.int64)
    lastb = np.empty(2 * len(runlens), np.int64)
    values[0::2] = rv
    values[1::2] = sv
    nbits[0::2] = rn
    nbits[1::2] = sn
    lastb[0::2] = rlast
    lastb[1::2] = np.where(has_symbol, slast, 0)

    keep = nbits > 0
    # the trailing run token may have nbits>0 but no symbol: keep zero-width
    # symbol slots out so lastbits[-1] is the true final emission
    return _emit_words(values[keep], nbits[keep], lastb[keep])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

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
