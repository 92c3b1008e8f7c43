"""Dazzler DB builder — the dex2DB engine (reference dex2DB.c:125-1077).

Create-or-append semantics with the reference's transactional protocol:
byte offsets of every binary file are recorded before any write, a new stub
image ``<root>.dbx`` is written alongside the old one, and on failure every
file is truncated back and the .dbx removed; success commits atomically by
renaming .dbx over .db (dex2DB.c:1017, 1024-1076).

Cell ingestion is batched and runs on the host, as in the JAX package
(``dextractor_tpu/db/build.py``, of which this is the port's own copy):
sequences are 2-bit packed by ``ops/twobit.pack_2bit_np``, QV streams go
through the per-cell scan -> Huffman tables -> per-entry encode flow of
``codecs/qv_codec`` (coding prefix ".qvs", no container key —
dex2DB.c:561-566),
arrow pulses are (value-1) packed with SNRs stowed in ``coff`` as 4x16 bits.
Well grouping flags DB_CCS on followers and DB_BEST on the longest read of
each group (dex2DB.c:649-685).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.errors import DextractorError
from ..utils.paths import path_to, root as rootof, catenate
from ..formats.ragged import pad_rows, rows_to_flat
from ..ops import twobit as tb
from ..codecs import qv_codec as qc
from ..formats import dexqv as dq
from . import model, stub as stub_mod

# The reference's default build defines HIDE_FILES (DB.h:22), so every binary
# DB file is written hidden: .NAME.idx/.bps/.qvs/.arw (DB.c:26, dex2DB.c:38).
PATHSEP = "/."


def binary_base(pwd: str, root: str) -> str:
    """Resolve the binary-file prefix of an existing DB: hidden ``/.root``
    (the reference default) wins, with a fallback to plain ``/root`` for DBs
    built by a non-HIDE_FILES reference build.  New DBs are always hidden."""
    hidden = catenate(pwd, "/.", root, "")
    plain = catenate(pwd, "/", root, "")
    if not os.path.exists(hidden + ".idx") and os.path.exists(plain + ".idx"):
        return plain
    return hidden


@dataclass
class CellData:
    """One SMRT cell's accepted (filtered) reads, columnar."""

    core: str                      # file root name
    prolog: str                    # movie name / header prolog
    wells: np.ndarray              # (N,) int32
    fpulses: np.ndarray            # (N,) int32
    qv1000: np.ndarray             # (N,) int32
    seqs: np.ndarray               # flat u8 ascii acgt
    lengths: np.ndarray            # (N,) int64
    qv_streams: np.ndarray | None = None   # (5, total) u8 phred'd streams
    pulses: np.ndarray | None = None       # flat u8 arrow codes 0..3 (value-1)
    snrs: np.ndarray | None = None         # (N, 4) float


def split_db(path: str, bsize: int, cutoff: int = 0, keep_all: bool = True) -> int:
    """Partition a DB into ~bsize-base blocks (DBsplit semantics implied by
    the stub grammar DB.h:425-435 and the append-extension loop
    dex2DB.c:953-991).  Returns the number of blocks."""
    pwd = path_to(path)
    root = rootof(path, ".db")
    stub_path = catenate(pwd, "/", root, ".db")
    stub = stub_mod.read_stub(stub_path)
    idx_path = binary_base(pwd, root) + ".idx"
    with open(idx_path, "rb") as f:
        raw = f.read()
    header = np.frombuffer(raw[: model.DB_DTYPE.itemsize], model.DB_DTYPE).copy()
    reads = np.frombuffer(raw, model.READ_DTYPE,
                          offset=model.DB_DTYPE.itemsize)

    allflag = 0 if keep_all else model.DB_BEST
    ublocks, tblocks = [0], [0]
    totlen = 0
    tfirst = 0
    for i in range(len(reads)):
        r = reads[i]
        if int(r["rlen"]) >= cutoff and (int(r["flags"]) & model.DB_BEST) >= allflag:
            tfirst += 1
            totlen += int(r["rlen"])
            if totlen >= bsize:
                ublocks.append(i + 1)
                tblocks.append(tfirst)
                totlen = 0
    if ublocks[-1] != len(reads) or len(ublocks) == 1:
        ublocks.append(len(reads))
        tblocks.append(tfirst)

    stub.partitioned = True
    stub.nblocks = len(ublocks) - 1
    stub.bsize = bsize
    stub.cutoff = cutoff
    stub.all = 1 if keep_all else 0
    stub.ublocks = ublocks
    stub.tblocks = tblocks
    stub_mod.write_stub(stub_path, stub)

    # NB: the on-disk header's allarr holds DB_ARROW only; the 'all' flag
    # lives in the stub and is OR'd in at open time (DB.c:818)
    header["cutoff"] = cutoff
    header["treads"] = tfirst
    with open(idx_path, "r+b") as f:
        f.write(header.tobytes())
    return stub.nblocks


class DBBuilder:
    def __init__(self, path: str, arrow: bool = False, quiver: bool = False,
                 lossy: bool = False, verbose: bool = False):
        self.pwd = path_to(path)
        self.root = rootof(path, ".db")
        self.dbname = catenate(self.pwd, "/", self.root, ".db")
        self.lossy = lossy
        self.verbose = verbose
        base = binary_base(self.pwd, self.root)
        self._p = lambda suf: base + suf

        self.exists = os.path.exists(self.dbname)
        self.created = []           # files created by this run (unlink on error)
        self.rollbacks = {}         # path -> original size (truncate on error)

        if not self.exists:
            self.stub = stub_mod.Stub()
            self.header = model.new_db_header()
            self.arrow = arrow
            self.quiver = quiver
            self.ureads = 0
            self.ureads0 = 0
            self.offset = 0
            self._open_new()
        else:
            self.stub = stub_mod.read_stub(self.dbname)
            with open(self._p(".idx"), "rb") as f:
                raw = f.read()
            self.header = np.frombuffer(raw[:model.DB_DTYPE.itemsize],
                                        model.DB_DTYPE).copy()
            nrec = (len(raw) - model.DB_DTYPE.itemsize) // model.READ_DTYPE.itemsize
            last = (np.frombuffer(raw, model.READ_DTYPE,
                                  offset=model.DB_DTYPE.itemsize + (nrec - 1)
                                  * model.READ_DTYPE.itemsize, count=1)
                    if nrec else None)
            # type enforcement (dex2DB.c:309-331)
            if last is not None and last["coff"][0] < 0:
                if arrow or quiver:
                    raise DextractorError(
                        "Sequence DB but you set either the -a or -q flag?")
                self.arrow = self.quiver = False
            elif (int(self.header["allarr"][0]) & model.DB_ARROW) != 0:
                if quiver:
                    raise DextractorError("Arrow DB but you set the -q flag?")
                self.arrow, self.quiver = True, False
            else:
                if arrow:
                    raise DextractorError("Quiver DB but you set the -a flag?")
                self.arrow, self.quiver = False, True
            self.ureads = int(self.header["ureads"][0])
            self.ureads0 = self.ureads      # pre-append count (qvchk ext)
            self.offset = os.path.getsize(self._p(".bps"))
            self.rollbacks[self._p(".idx")] = os.path.getsize(self._p(".idx"))
            self.rollbacks[self._p(".bps")] = self.offset
            if self.quiver:
                self.rollbacks[self._p(".qvs")] = os.path.getsize(self._p(".qvs"))
            if self.arrow:
                self.rollbacks[self._p(".arw")] = os.path.getsize(self._p(".arw"))

        self.flist = list(dict.fromkeys(self.stub.fname))
        self.new_count = np.zeros(4, np.int64)
        self.new_totlen = 0
        self.new_maxlen = 0

    def _open_new(self):
        for suf in [".bps", ".idx"] + ([".qvs"] if self.quiver else []) \
                + ([".arw"] if self.arrow else []):
            p = self._p(suf)
            with open(p, "wb") as f:
                if suf == ".idx":
                    f.write(self.header.tobytes())
            self.created.append(p)

    # ------------------------------------------------------------------

    def add_cell(self, cell: CellData) -> None:
        if cell.core in self.flist:
            raise DextractorError(
                f"File {cell.core} is already in database {self.root}.db")
        self.flist.append(cell.core)

        n = len(cell.wells)
        lengths = cell.lengths.astype(np.int64)
        clens = (lengths + 3) >> 2

        recs = np.zeros(n, model.READ_DTYPE)
        recs["origin"] = cell.wells
        recs["fpulse"] = cell.fpulses
        recs["rlen"] = lengths
        boffs = self.offset + np.concatenate([[0], np.cumsum(clens[:-1])])
        recs["boff"] = boffs
        recs["flags"] = cell.qv1000
        recs["coff"] = -1

        # base frequency count over the raw sequences (dex2DB.c:587-591)
        codes_flat = tb.NUMBER_BASE_LUT[cell.seqs]
        self.new_count += np.bincount(codes_flat, minlength=4)[:4]
        self.new_totlen += int(lengths.sum())
        if n:
            self.new_maxlen = max(self.new_maxlen, int(lengths.max()))

        # 2-bit pack sequences -> .bps
        rows = pad_rows(codes_flat, lengths, align=4)
        packed = tb.pack_2bit_np(rows, lengths)
        payload = rows_to_flat(packed, clens)
        with open(self._p(".bps"), "ab") as f:
            f.write(payload.tobytes())

        # QV streams -> .qvs (per-cell coding, prefix ".qvs", no container key)
        if self.quiver:
            if cell.qv_streams is None:
                raise DextractorError(f"{cell.core} does not have Quiver information")
            stats = qc.scan_streams(cell.qv_streams, lengths)
            coding = qc.create_qvcoding(stats, b".qvs", self.lossy)
            qpos = os.path.getsize(self._p(".qvs"))
            blobs = []
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lengths, out=off[1:])
            head = dq.qvcoding_bytes(coding)
            for i in range(n):
                s, e = off[i], off[i + 1]
                blobs.append(qc.encode_entry(
                    coding,
                    cell.qv_streams[0, s:e], cell.qv_streams[1, s:e],
                    cell.qv_streams[2, s:e], cell.qv_streams[3, s:e],
                    cell.qv_streams[4, s:e], self.lossy))
            # coff of entry i = file position before its blob, except the
            # first entry whose coff points at the coding header itself
            # (dex2DB.c:565-566, 617-621: qpos is captured before
            # Write_QVcoding and only advanced after each entry)
            sizes = np.array([len(b) for b in blobs], np.int64)
            starts = qpos + len(head) + np.concatenate([[0], np.cumsum(sizes[:-1])])
            if n:
                starts[0] = qpos
            recs["coff"] = starts
            with open(self._p(".qvs"), "ab") as f:
                f.write(head)
                f.write(b"".join(blobs))

        # Arrow pulses -> .arw, SNRs into coff
        if self.arrow:
            if cell.pulses is None or cell.snrs is None:
                raise DextractorError(f"{cell.core} does not have Arrow information")
            prows = pad_rows(cell.pulses, lengths, align=4)
            ppacked = tb.pack_2bit_np(prows, lengths)
            with open(self._p(".arw"), "ab") as f:
                f.write(rows_to_flat(ppacked, clens).tobytes())
            cnr = (cell.snrs.astype(np.float64) * 100.0).astype(np.uint16)
            recs["coff"] = model.pack_snr_coff(cnr.reshape(n, 4))

        # well grouping: DB_CCS on followers, DB_BEST on longest per group
        if n:
            newgrp = np.empty(n, bool)
            newgrp[0] = True
            newgrp[1:] = cell.wells[1:] != cell.wells[:-1]
            gid = np.cumsum(newgrp) - 1
            recs["flags"][~newgrp] |= model.DB_CCS
            # first-longest read per group gets DB_BEST (strict > comparison
            # keeps the earliest maximum, dex2DB.c:665-669)
            order = np.lexsort((np.arange(n), -lengths, gid))
            first_of_group = np.empty(n, bool)
            first_of_group[0] = True
            first_of_group[1:] = gid[order][1:] != gid[order][:-1]
            is_best = np.zeros(n, bool)
            is_best[order[first_of_group]] = True
            recs["flags"][is_best] |= model.DB_BEST

        with open(self._p(".idx"), "ab") as f:
            f.write(recs.tobytes())

        self.offset += int(clens.sum())
        self.ureads += n
        self.stub.nfiles += 1
        self.stub.nreads.append(self.ureads)
        self.stub.fname.append(cell.core)
        self.stub.prolog.append(cell.prolog)

    # ------------------------------------------------------------------

    def finalize(self) -> None:
        hdr = self.header
        ct = self.new_count
        tl = self.new_totlen
        if not self.exists:
            hdr["freq"] = (ct / tl if tl else np.zeros(4)).astype(np.float32)
            hdr["totlen"] = tl
            hdr["maxlen"] = self.new_maxlen
            hdr["cutoff"] = -1
            hdr["allarr"] = model.DB_ARROW if self.arrow else 0
        else:
            old_tl = int(hdr["totlen"][0])
            hdr["freq"] = ((hdr["freq"][0].astype(np.float64) * old_tl + ct)
                           / (old_tl + tl)).astype(np.float32)
            hdr["totlen"] = old_tl + tl
            hdr["maxlen"] = max(int(hdr["maxlen"][0]), self.new_maxlen)
        hdr["ureads"] = self.ureads

        # extend the block partition if the DB was split (dex2DB.c:920-997)
        if int(hdr["cutoff"][0]) >= 0 and self.stub.partitioned:
            cutoff = self.stub.cutoff
            allflag = 0 if self.stub.all else model.DB_BEST
            size = self.stub.bsize
            # drop the last (partial) block boundary and recompute forward
            self.stub.ublocks = self.stub.ublocks[:-1]
            self.stub.tblocks = self.stub.tblocks[:-1]
            nblock = len(self.stub.ublocks) - 1
            ufirst = self.stub.ublocks[-1]
            tfirst = self.stub.tblocks[-1]
            with open(self._p(".idx"), "rb") as f:
                f.seek(model.DB_DTYPE.itemsize
                       + model.READ_DTYPE.itemsize * ufirst)
                raw = f.read()
            recs = np.frombuffer(raw, model.READ_DTYPE)
            totlen = 0
            ireads = 0
            for i in range(ufirst, self.ureads):
                r = recs[i - ufirst]
                rl = int(r["rlen"])
                if rl >= cutoff and (int(r["flags"]) & model.DB_BEST) >= allflag:
                    ireads += 1
                    tfirst += 1
                    totlen += rl
                    if totlen >= size:
                        self.stub.ublocks.append(i + 1)
                        self.stub.tblocks.append(tfirst)
                        totlen = 0
                        ireads = 0
                        nblock += 1
            if ireads > 0:
                self.stub.ublocks.append(self.ureads)
                self.stub.tblocks.append(tfirst)
                nblock += 1
            self.stub.nblocks = nblock
            hdr["treads"] = tfirst
        else:
            hdr["treads"] = self.ureads

        # rewrite the header record in .idx
        with open(self._p(".idx"), "r+b") as f:
            f.write(hdr.tobytes())

        # atomic commit: .dbx -> .db
        dbx = os.path.join(self.pwd, self.root + ".dbx")
        stub_mod.write_stub(dbx, self.stub)
        os.replace(dbx, self.dbname)

        # post-commit, best-effort: the qvchk QV-decode index track
        # (per-read channel boundaries + long-read segment checkpoints,
        # db/qvtrack.py).  Appends extend the existing track with only
        # the new cells' records (cost proportional to the append, like
        # dex2DB.c:577-685); a missing/stale/mismatched track triggers
        # a full rebuild.  A failure leaves a valid DB whose QV loads
        # fall back to the load-time walk — but it must be VISIBLE: a
        # silent failure here would degrade every future DB open with
        # no trace.  An interrupted run can
        # leave a stale track: its length then mismatches ureads and
        # check_track rejects it (reference stale-track semantics).
        if self.quiver:
            import sys

            try:
                from .qvtrack import write_qvchk_track

                ok = write_qvchk_track(self.dbname,
                                       prev_ureads=self.ureads0)
                if self.verbose and ok:
                    print(f"  Wrote QV index track .{self.root}.qvchk")
                if not ok:
                    print(f"Warning: could not build QV index track "
                          f".{self.root}.qvchk (native walker "
                          f"unavailable?); QV loads fall back to the "
                          f"sequential walk", file=sys.stderr)
            except Exception as e:
                print(f"Warning: QV index track .{self.root}.qvchk "
                      f"failed ({type(e).__name__}: {e}); QV loads "
                      f"fall back to the sequential walk",
                      file=sys.stderr)

    def rollback(self) -> None:
        """Restore every binary file to its pre-run size (dex2DB.c:1024-1076)."""
        for p, size in self.rollbacks.items():
            try:
                with open(p, "r+b") as f:
                    f.truncate(size)
            except OSError:
                pass
        for p in self.created:
            try:
                os.unlink(p)
            except OSError:
                pass
        dbx = os.path.join(self.pwd, self.root + ".dbx")
        if os.path.exists(dbx):
            os.unlink(dbx)
