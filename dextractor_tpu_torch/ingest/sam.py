"""SAM/BAM reader for PacBio subread files.

The reference's sam module (sam.c/sam.h) is truncated in the snapshot — its
``samRecord`` lacks every PacBio field its call sites use (SURVEY.md §2c).
This implementation provides the *intended* surface, recovered from the call
sites (dextract.c:130-161, 375-424; dex2DB.c:691-887) and the PacBio BAM
spec:

  per record: header (movie), well, beg, end, qual (rq, 0..1 float), len,
  seq, arr (pulse-width chars '1'-'4'), snr[4], qv[5] (del/tag/ins/mrg/sub,
  FASTQ-encoded), bc[2], bqual, nump.

BAM is BGZF-compressed (zlib); both the binary BAM record layout and SAM
text are handled.  ``header_status`` returns the HASQV/HASPW bits by
probing the first record's aux tags (the snapshot's version promised to
parse README DS tags but was unfinished, sam.c:318-355).

Reading STREAMS record-by-record like the reference (sam.c:107-188 reads
through a zlib gzFile): a chunked multi-member BGZF inflater feeds a
rolling buffer from which records are parsed incrementally, so a
multi-GB .subreads.bam never needs to fit in RAM.  Each iterator opens
its own file handle, so header probing does not disturb iteration.  The
port's own copy of ``dextractor_tpu/ingest/sam.py``.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..utils.errors import FormatError

HASQV = 0x1
HASPW = 0x2

_CHUNK = 1 << 20


@dataclass
class SamRecord:
    header: bytes          # movie name
    well: int
    beg: int
    end: int
    qual: float
    len: int
    seq: bytes
    arr: bytes | None      # pulse width chars
    snr: np.ndarray | None
    qv: list | None        # 5 streams: del, tag, ins, mrg, sub
    bc: tuple = (-1, -1)
    bqual: int = -1
    nump: int = -1


_SEQ_CODE = b"=ACMGRSVTWYHKDBN"


def _inflate_chunks(f, first: bytes = b""):
    """Yield inflated chunks from a BGZF / multi-member gzip / plain file.

    BGZF is thousands of <=64KB gzip members plus an empty EOF member;
    the decompressobj is restarted on every member boundary via
    ``unused_data`` so arbitrarily many members stream in O(chunk) memory
    (the reference reads through a zlib gzFile, sam.c:107-188).
    """
    head = first if len(first) >= 2 else first + f.read(2 - len(first))
    if head[:2] != b"\x1f\x8b":
        if head:
            yield head
        while True:
            c = f.read(_CHUNK)
            if not c:
                return
            yield c
        return

    d = zlib.decompressobj(31)
    pending = head
    while True:
        if not pending:
            pending = f.read(_CHUNK)
            if not pending:
                break
        out = d.decompress(pending)
        if out:
            yield out
        if d.eof:
            pending = d.unused_data
            d = zlib.decompressobj(31)
        else:
            pending = b""
    tail = d.flush()
    if tail:
        yield tail


class _StreamBuf:
    """Rolling buffer over an inflated-chunk generator."""

    def __init__(self, chunks):
        self._chunks = chunks
        self._buf = bytearray()
        self._pos = 0
        self.eof = False

    def ensure(self, n: int) -> bool:
        """Make >= n bytes available at the cursor; False at clean EOF."""
        while len(self._buf) - self._pos < n:
            # compact consumed prefix before growing
            if self._pos > (1 << 22):
                del self._buf[: self._pos]
                self._pos = 0
            try:
                self._buf += next(self._chunks)
            except StopIteration:
                self.eof = True
                return len(self._buf) - self._pos >= n
        return True

    def take(self, n: int) -> bytes:
        if not self.ensure(n):
            raise FormatError("truncated BAM stream")
        v = bytes(self._buf[self._pos: self._pos + n])
        self._pos += n
        return v

    def at_eof(self) -> bool:
        return not self.ensure(1)

    def lines(self):
        """Iterate text lines (for SAM)."""
        while True:
            nl = self._buf.find(b"\n", self._pos)
            while nl < 0:
                if self._pos > (1 << 22):
                    del self._buf[: self._pos]
                    self._pos = 0
                try:
                    self._buf += next(self._chunks)
                except StopIteration:
                    if self._pos < len(self._buf):
                        yield bytes(self._buf[self._pos:])
                        self._pos = len(self._buf)
                    return
                nl = self._buf.find(b"\n", self._pos)
            yield bytes(self._buf[self._pos: nl])
            self._pos = nl + 1


def _parse_aux(buf: memoryview, off: int, end: int, is_big: bool) -> dict:
    """Parse BAM aux tags into {tag: value} (sam.c:385-438's role)."""
    raw = bytes(buf)              # a string tag ends at the next NUL: one search
    e = ">" if is_big else "<"
    tags = {}
    sizes = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    fmts = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}
    while off < end:
        tag = bytes(buf[off:off + 2]).decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ in sizes:
            (v,) = struct.unpack_from(e + fmts[typ], buf, off)
            off += sizes[typ]
            tags[tag] = v
        elif typ in "ZH":
            z = raw.index(0, off)
            tags[tag] = raw[off:z]
            off = z + 1
        elif typ == "A":
            tags[tag] = chr(buf[off])
            off += 1
        elif typ == "B":
            sub = chr(buf[off])
            (cnt,) = struct.unpack_from(e + "i", buf, off + 1)
            off += 5
            arr = np.frombuffer(buf[off: off + cnt * sizes[sub]],
                                dtype=np.dtype(e + fmts[sub]), count=cnt)
            off += cnt * sizes[sub]
            tags[tag] = arr
        else:
            raise FormatError(f"unknown BAM aux tag type '{typ}'")
    return tags


def _qname_fields(qname: bytes):
    """movie/well/beg_end from a PacBio subread name."""
    parts = qname.split(b"/")
    movie = parts[0]
    well = int(parts[1]) if len(parts) > 1 else 0
    beg = endp = 0
    if len(parts) > 2 and b"_" in parts[2]:
        b_, e_ = parts[2].split(b"_", 1)
        beg, endp = int(b_), int(e_)
    return movie, well, beg, endp


def _record_from_fields(qname, seq, tags) -> SamRecord:
    movie, well, beg, endp = _qname_fields(qname)
    qs = int(tags.get("qs", beg))
    qe = int(tags.get("qe", endp if endp else len(seq)))
    rq = float(tags.get("rq", 0.0))
    snr = tags.get("sn")
    if snr is not None:
        snr = np.asarray(snr, np.float32)
    pw = tags.get("pw")
    arr = None
    if pw is not None:
        if isinstance(pw, np.ndarray):
            a = np.minimum(pw.astype(np.int64), 4).astype(np.uint8)
            a = np.maximum(a, 1)
            arr = (a + ord("0")).astype(np.uint8).tobytes()
        else:
            arr = bytes(pw)
    qv = None
    if all(t in tags for t in ("dq", "dt", "iq", "mq", "sq")):
        qv = [tags["dq"], tags["dt"], tags["iq"], tags["mq"], tags["sq"]]
    bc = tags.get("bc")
    if isinstance(bc, np.ndarray) and len(bc) >= 2:
        bc = (int(bc[0]), int(bc[1]))
    else:
        bc = (-1, -1)
    return SamRecord(
        header=movie, well=well, beg=qs, end=qe, qual=rq,
        len=len(seq), seq=seq, arr=arr, snr=snr, qv=qv, bc=bc,
        bqual=int(tags.get("bq", -1)), nump=int(tags.get("np", -1)))


def _skip_bam_header(buf) -> bytes:
    """Consume the BAM header after its magic: header text plus the
    reference directory (sam.c:200-240).  Returns the header text."""
    (l_text,) = struct.unpack("<i", buf.take(4))
    text = buf.take(l_text)
    (n_ref,) = struct.unpack("<i", buf.take(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", buf.take(4))
        buf.take(l_name + 4)
    return text


class SamReader:
    """Open a .subreads.bam / .subreads.sam and stream records."""

    def __init__(self, path: str):
        self.path = path
        # sniff type + capture the header by streaming just its prefix
        with open(path, "rb") as f:
            buf = _StreamBuf(_inflate_chunks(f))
            self.is_bam = buf.ensure(4) and bytes(
                buf._buf[buf._pos: buf._pos + 4]) == b"BAM\x01"
            if self.is_bam:
                buf.take(4)                      # magic
                self.header_text = _skip_bam_header(buf)
            else:
                self.header_lines = []
                for line in buf.lines():
                    if not line.startswith(b"@"):
                        break
                    self.header_lines.append(line)
                self.header_text = b"\n".join(self.header_lines)

    # -- BAM ---------------------------------------------------------------

    def _iter_bam(self):
        with open(self.path, "rb") as f:
            buf = _StreamBuf(_inflate_chunks(f))
            buf.take(4)                          # magic
            _skip_bam_header(buf)
            while not buf.at_eof():
                (block,) = struct.unpack("<i", buf.take(4))
                rec = memoryview(buf.take(block))
                (_, _, l_qname, _, _, n_cigar, _, l_seq, _, _) = \
                    struct.unpack_from("<iiBBHHHiii", rec, 0)
                p = 32
                qname = bytes(rec[p:p + l_qname - 1])
                p += l_qname + 4 * n_cigar
                nb = (l_seq + 1) // 2
                packed = np.frombuffer(rec[p:p + nb], np.uint8)
                codes = np.empty(2 * nb, np.uint8)
                codes[0::2] = packed >> 4
                codes[1::2] = packed & 0xF
                seq = np.frombuffer(_SEQ_CODE, np.uint8)[codes[:l_seq]].tobytes()
                p += nb + l_seq                 # skip qual
                tags = _parse_aux(rec, p, block, False)
                yield qname, seq, tags

    # -- SAM ---------------------------------------------------------------

    def _iter_sam(self):
        with open(self.path, "rb") as fh:
            buf = _StreamBuf(_inflate_chunks(fh))
            lines = buf.lines()
            yield from self._parse_sam_lines(lines)

    def _parse_sam_lines(self, lines):
        for line in lines:
            if not line or line.startswith(b"@"):
                continue
            f = line.split(b"\t")
            if len(f) < 11:
                raise FormatError("SAM record with fewer than 11 fields")
            qname, seq = f[0], f[9]
            tags = {}
            for t in f[11:]:
                parts = t.split(b":", 2)
                if len(parts) != 3:
                    continue
                tag, typ, val = parts[0].decode(), parts[1].decode(), parts[2]
                if typ == "i":
                    tags[tag] = int(val)
                elif typ == "f":
                    tags[tag] = float(val)
                elif typ in "ZH":
                    tags[tag] = val
                elif typ == "A":
                    tags[tag] = val.decode()
                elif typ == "B":
                    sub = chr(val[0])
                    nums = val[2:].split(b",") if len(val) > 2 else []
                    dt = np.float32 if sub == "f" else np.int64
                    tags[tag] = np.array([dt(x) for x in nums])
            yield qname, seq, tags

    # -- public ------------------------------------------------------------

    def __iter__(self):
        it = self._iter_bam() if self.is_bam else self._iter_sam()
        for qname, seq, tags in it:
            yield _record_from_fields(qname, seq, tags)

    def header_status(self) -> int:
        """HASQV/HASPW bits, from the @RG DS: description when present.

        The PacBio BAM spec carries the per-file stream inventory in the
        read-group description (``DS:READTYPE=SUBREAD;DeletionQV=dq;...;
        PulseWidth:CodecV1=pw``); the reference's sam_header_process set
        out to parse it but was left unfinished (sam.c:318-355, the
        dangling ``desc/subs/pw`` locals).  Files without a DS field fall
        back to probing the first record's aux tags — equivalent, since
        every record of a PacBio movie carries the same streams."""
        ds = self._rg_description()
        if ds is not None:
            status = 0
            fields = dict(
                kv.split(b"=", 1) for kv in ds.split(b";") if b"=" in kv)
            if all(fields.get(k) for k in (b"DeletionQV", b"DeletionTag",
                                           b"InsertionQV", b"MergeQV",
                                           b"SubstitutionQV")):
                status |= HASQV
            if fields.get(b"PulseWidth:CodecV1") or fields.get(b"PulseWidth"):
                status |= HASPW
            return status
        it = self._iter_bam() if self.is_bam else self._iter_sam()
        for _, _, tags in it:
            status = 0
            if all(t in tags for t in ("dq", "dt", "iq", "mq", "sq")):
                status |= HASQV
            if "pw" in tags:
                status |= HASPW
            return status
        return 0

    def _rg_description(self) -> bytes | None:
        """The DS: field of the first @RG header line, or None."""
        for line in self.header_text.split(b"\n"):
            if not line.startswith(b"@RG"):
                continue
            for col in line.split(b"\t")[1:]:
                if col.startswith(b"DS:"):
                    return col[3:]
        return None
