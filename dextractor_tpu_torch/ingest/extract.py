"""Subread extraction: parsed instrument records -> .fasta/.arrow/.quiva text.

Replicates writeSubread / writeSamRecord (dextract.c:28-161) including their
formatting quirks:

- bax arrow lines get one unconditional trailing newline after the sequence
  (``if (a % 80 != 80)`` is always true, dextract.c:57-58), producing a blank
  line when len % 80 == 0;
- arrow headers carry only the movie name + SN (no well/pulse fields);
- bax QVs are Phred+33 shifted with values > 93 clamped to chr(126)
  (dextract.c:99-118); delTag is lowercased and 'n'-substituted where
  delQV equals the delLimit;
- quiva headers use '@' in both paths (the snapshot's sam path wrote '>',
  a known defect — SURVEY.md §2c.3 — not replicated).

The port's own copy of ``dextractor_tpu/ingest/extract.py``.
"""

from __future__ import annotations

import numpy as np

PHRED_OFFSET = 33
LOWER_OFFSET = 32


def _wrap80(seq: bytes) -> bytes:
    out = []
    for i in range(0, len(seq), 80):
        out.append(seq[i:i + 80])
    return b"\n".join(out) + b"\n" if out else b""


def _arrow_body(seq: bytes) -> bytes:
    """dextract's arrow writer: newline every 80 chars plus one
    unconditional trailing newline (dextract.c:49-58)."""
    out = []
    n = len(seq)
    for i in range(0, n, 80):
        chunk = seq[i:i + 80]
        if len(chunk) == 80:
            out.append(chunk + b"\n")
        else:
            out.append(chunk)
    body = b"".join(out)
    return body + b"\n"


def phred33(qv: np.ndarray) -> np.ndarray:
    """Raw QV -> printable: +33, clamp >93 to 126 (dextract.c:99-118)."""
    q = qv.astype(np.int64)
    return np.where(q > 93, 126, q + PHRED_OFFSET).astype(np.uint8)


def fasta_entry(header: bytes, well: int, beg: int, end: int, qv1000: int,
                seq: bytes, lower: bool = False) -> bytes:
    if lower and seq[:1].isupper():
        seq = seq.lower()
    return (b">%s/%d/%d_%d RQ=0.%d\n" % (header, well, beg, end, qv1000)
            + _wrap80(seq))


def arrow_entry(header: bytes, snr, seq: bytes) -> bytes:
    hdr = b">%s SN=%.2f,%.2f,%.2f,%.2f\n" % (
        header, snr[0], snr[1], snr[2], snr[3])
    return hdr + _arrow_body(seq)


def quiva_entry(header: bytes, well: int, beg: int, end: int, qv1000: int,
                streams: list[bytes]) -> bytes:
    hdr = b"@%s/%d/%d_%d RQ=0.%d\n" % (header, well, beg, end, qv1000)
    return hdr + b"".join(s + b"\n" for s in streams)


def pulses_to_chars(pulse: np.ndarray) -> bytes:
    """uint16 pulse widths -> '0'..'4' chars, clamped at '4'
    (dextract.c:49-53: >=4 prints '4', else pulse+'0')."""
    p = np.minimum(pulse.astype(np.int64), 4)
    return (p + ord("0")).astype(np.uint8).tobytes()
