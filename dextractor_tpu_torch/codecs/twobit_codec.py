""".fasta <-> .dexta and .arrow <-> .dexar codecs
(``dextractor_tpu/codecs/twobit_codec.py``).

The host control plane parses the text and frames the containers byte for
byte (reference encoders dexta.c:102-205 / dexar.c:101-211, decoders
undexta.c:131-271 / undexar.c:129-229).  The data plane is the 2-bit pack
and unpack over the flat ragged buffers (the reads end to end):

- on a device, ``ops.pack2bit.pack2bit`` (K7) packs the bases through the
  alphabet's table into the container's flat payload, and
  ``ops.pack2bit.unpack2bit`` unpacks the payload into exactly each read's
  letters; only those bytes cross between host and card, and no padded
  rectangle is built on either side;
- on the host (``device=False``), the native C loops of
  ``native/twobit_host.c``: the (threaded) pack, and an unpack that writes
  the wrapped text in one pass.

``device``: None -> ``utils.dispatch.device_default()`` (``DXT_DEVICE``,
else CUDA when present); True -> CUDA; "cpu" or a torch.device -> the device
pipeline there ("cpu" runs the kernels' plain twins); False -> the native
host path (where it cannot build, the twins on the CPU do its work).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..formats import dexta as dx
from ..formats import fasta as fa
from ..native import qv_encode_shim, twobit_host_shim
from ..ops import twobit as tb
from ..ops.pack2bit import pack2bit, unpack2bit
from ..utils.dispatch import resolve_device
from ..utils.errors import FormatError
from ..utils.profiling import stage


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _offsets(lengths: np.ndarray) -> np.ndarray:
    """(N+1,) int64: 0 and the running sum of ``lengths``."""
    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    return offs


# threshold for the chunk-threaded host pack (tests lower it to pin the
# threaded path's byte-identity on small inputs)
_PACK_THREAD_MIN_BYTES = 8 << 20


def _pack_native(seqs_flat, lengths, number_lut, clens):
    """The payload of every read by the native pack, one pass over the
    flat bases; raises OSError when the shim cannot build."""
    lib = twobit_host_shim()
    n = len(lengths)
    offs = _offsets(lengths)
    couts = _offsets(clens)
    cap = int(couts[-1])
    out = np.empty(max(cap, 1), np.uint8)
    out_lens = np.zeros(n, np.int64)
    sf = np.ascontiguousarray(seqs_flat)
    nl = np.ascontiguousarray(number_lut)
    # packed lengths are exactly ceil(len/4), so chunk output offsets are
    # known upfront and the pack parallelizes over entry ranges (ctypes
    # releases the GIL; the reference tool is single-threaded by design)
    nt = min(os.cpu_count() or 1, 4, max(n, 1))
    if nt > 1 and cap >= _PACK_THREAD_MIN_BYTES:
        # split by output *bytes*, not entry count: skewed read lengths
        # would otherwise collapse the pack to one thread
        targets = [(i * cap) // nt for i in range(nt + 1)]
        bounds = np.searchsorted(couts, targets, "left").tolist()
        bounds[0], bounds[-1] = 0, n

        def _one(t):
            lo, hi = bounds[t], bounds[t + 1]
            if lo == hi:
                return 0
            return lib.dxt_pack_seq(
                _ptr(sf), _ptr(offs[lo:]), hi - lo, _ptr(nl),
                ctypes.c_void_p(out.ctypes.data + int(couts[lo])),
                cap - int(couts[lo]), _ptr(out_lens[lo:]))

        with ThreadPoolExecutor(nt) as ex:
            ok = all(r >= 0 for r in ex.map(_one, range(nt)))
    else:
        ok = lib.dxt_pack_seq(_ptr(sf), _ptr(offs), n, _ptr(nl),
                              _ptr(out), cap, _ptr(out_lens)) >= 0
    if not ok:
        raise FormatError("native 2-bit pack buffer overflow")
    return out[:cap]


def _pack_batch(seqs_flat, lengths, number_lut, dev: torch.device | None):
    """Pack ragged ascii bases into their reads' 2-bit payloads, end to end.
    Returns (payload (sum clens,) u8, clens (N,) int64)."""
    lengths = np.asarray(lengths, np.int64)
    clens = tb.compressed_len(lengths)
    if dev is None:
        try:
            return _pack_native(seqs_flat, lengths, number_lut, clens), clens
        except OSError:
            dev = torch.device("cpu")
    couts = _offsets(clens)
    payload = pack2bit(torch.from_numpy(np.ascontiguousarray(seqs_flat)).to(dev),
                       torch.from_numpy(_offsets(lengths)).to(dev),
                       torch.from_numpy(couts).to(dev),
                       torch.from_numpy(number_lut).to(dev), int(couts[-1]))
    return payload.cpu().numpy(), clens


def _native_seq_text(headers, payload, clens, rlens, letter4, width):
    """Assemble the width-wrapped text image with the native unpacker
    (one pass per read), or return None when the shim is unavailable."""
    try:
        lib = twobit_host_shim()
        qe = qv_encode_shim()
    except OSError:
        return None
    n = len(rlens)
    rlens = np.ascontiguousarray(rlens.astype(np.int64))
    w = int(width) if width > 0 else (1 << 60)
    nlines = (rlens + w - 1) // w
    hdr_lens = np.array([len(h) for h in headers], np.int64)
    blk = hdr_lens + 1 + rlens + nlines
    blk_off = _offsets(blk)
    out = np.full(int(blk_off[-1]), ord("\n"), np.uint8)
    hdr_flat = np.frombuffer(b"".join(headers), np.uint8)
    dst = np.ascontiguousarray(blk_off[:-1])
    qe.dxt_ragged_copy(_ptr(out), _ptr(dst), _ptr(hdr_flat),
                       _ptr(np.ascontiguousarray(hdr_lens)), n)
    pay_offs = _offsets(clens)
    seq_offs = np.ascontiguousarray(blk_off[:-1] + hdr_lens + 1)
    pay = np.ascontiguousarray(payload)
    lut = np.ascontiguousarray(letter4)
    lib.dxt_unpack_text(_ptr(pay), _ptr(pay_offs), _ptr(rlens), n, w,
                        _ptr(lut), _ptr(out), _ptr(seq_offs))
    return out.tobytes()


def _unpack_batch(payload, clens, rlens, letter_lut, dev: torch.device):
    """Unpack the reads' payloads (end to end) into their letters, exactly
    rlens[i] per read, end to end."""
    out_offs = _offsets(rlens)
    sym = unpack2bit(torch.from_numpy(np.ascontiguousarray(payload)).to(dev),
                     torch.from_numpy(_offsets(clens)).to(dev),
                     torch.from_numpy(out_offs).to(dev),
                     torch.from_numpy(letter_lut).to(dev), int(out_offs[-1]))
    return sym.cpu().numpy()


def _decode_text(headers, d, rlens, letter_lut, width, dev) -> bytes:
    """The text image of a read container: the native path when ``dev`` is
    None (and it builds), else the device unpack and the host assembly."""
    total = int(rlens.sum())
    if dev is None:
        with stage("decode+assemble", total):
            txt = _native_seq_text(headers, d.payload.flat, d.payload.lengths,
                                   rlens, letter_lut, width)
        if txt is not None:
            return txt
        dev = torch.device("cpu")
    with stage("decode", total):
        sym = _unpack_batch(d.payload.flat, d.payload.lengths, rlens, letter_lut, dev)
    with stage("assemble", total):
        return fa.write_seq_file(headers, sym, rlens, width=width)


def _read_lengths(d) -> np.ndarray:
    rlens = (d.ends.astype(np.int64) - d.begs)
    if (rlens < 0).any():
        raise FormatError("a read's end lies before its beginning")
    return rlens


# ---------------------------------------------------------------------------
# .dexta
# ---------------------------------------------------------------------------

def encode_fasta_to_dexta(data: bytes, device=None) -> bytes:
    dev = resolve_device(device)
    with stage("parse", len(data)):
        f = fa.parse_seq_file(data, arrow=False)
    with stage("encode", int(f.seqs.lengths.sum())):
        payload, clens = _pack_batch(f.seqs.flat, f.seqs.lengths,
                                     tb.NUMBER_BASE_LUT, dev)
    with stage("assemble", int(clens.sum())):
        return dx.write_dexta(f.prefix, f.wells, f.begs, f.ends, f.qvs,
                              payload, clens)


def decode_dexta_to_fasta(data: bytes, width: int = 80, upper: bool = False,
                          device=None) -> bytes:
    dev = resolve_device(device)
    with stage("parse", len(data)):
        d = dx.read_dexta(data, arrow=False)
        rlens = _read_lengths(d)
        headers = fa.format_headers(d.prefix, d.wells, d.begs, d.ends,
                                    qvs=d.qvs)
    return _decode_text(headers, d, rlens, tb.UPPER_LUT if upper else tb.LOWER_LUT,
                        width, dev)


# ---------------------------------------------------------------------------
# .dexar
# ---------------------------------------------------------------------------

def _snr_to_cnr(snrs: np.ndarray) -> np.ndarray:
    """float SNR -> uint16 snr*100, truncated, clamped at 9999 when > 99.99
    (reference dexar.c:159-163: the comparison is in double, the cast
    truncates)."""
    s = snrs.astype(np.float64)
    return np.where(s > 99.99, 9999, (s * 100.0).astype(np.int64)).astype(np.uint16)


def encode_arrow_to_dexar(data: bytes, device=None) -> bytes:
    dev = resolve_device(device)
    with stage("parse", len(data)):
        f = fa.parse_seq_file(data, arrow=True)
    with stage("encode", int(f.seqs.lengths.sum())):
        payload, clens = _pack_batch(f.seqs.flat, f.seqs.lengths,
                                     tb.NUMBER_ARROW_LUT, dev)
    with stage("assemble", int(clens.sum())):
        return dx.write_dexar(f.prefix, f.wells, f.begs, f.ends,
                              _snr_to_cnr(f.snrs), payload, clens)


def decode_dexar_to_arrow(data: bytes, width: int = 80, device=None) -> bytes:
    dev = resolve_device(device)
    with stage("parse", len(data)):
        d = dx.read_dexta(data, arrow=True)
        rlens = _read_lengths(d)
        snrs = d.cnrs.astype(np.float64) / 100.0
        headers = fa.format_headers(d.prefix, d.wells, d.begs, d.ends, snrs=snrs)
    return _decode_text(headers, d, rlens, tb.ARROW_LETTER_LUT, width, dev)
