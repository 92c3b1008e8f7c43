"""Dazzler DB access library (reference DB.c:690-2644).

``open_db`` reads the stub + .idx (whole DB or one block part ``path.N``),
``DazzDB`` provides trim, sequence/arrow/QV loading and generic tracks.
Batch loaders return columnar NumPy data; ``load_all_qventries`` decodes
every read's QV streams on the device (the CUDA decode kernels on the card,
their plain twins on the CPU).  The scalar loaders mirror Load_Read /
Load_QVentry / Load_Arrow semantics and run on the host.  The port's own
copy of ``dextractor_tpu/db/access.py``; the ``mesh`` argument of its QV
load is not ported.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.errors import DextractorError, FormatError
from ..utils.profiling import stage
from ..utils.paths import path_to, root as rootof, catenate
from ..ops import twobit as tb
from ..formats.ragged import flat_gather_lens
from ..formats import dexqv as dq
from . import model, stub as stub_mod
from .build import binary_base


@dataclass
class DazzDB:
    path: str                     # hidden-file root: <pwd>/<root>
    stub_path: str
    header: np.ndarray            # (1,) DB_DTYPE
    reads: np.ndarray             # (nreads,) READ_DTYPE
    part: int
    ufirst: int
    tfirst: int
    trimmed: bool = False
    cutoff: int = 0
    allarr: int = 0
    _qv: object = None
    _arrow_loaded: bool = False

    @property
    def nreads(self) -> int:
        return len(self.reads)

    @property
    def is_arrow(self) -> bool:
        return (self.allarr & model.DB_ARROW) != 0

    # -- trim ----------------------------------------------------------

    def trim(self) -> None:
        """Trim_DB (DB.c:908-1039): apply cutoff + best-of-well, rewriting
        the DB_CCS chain flags of the retained reads."""
        if self.trimmed:
            return
        if self.cutoff <= 0 and (self.allarr & model.DB_ALL) != 0:
            self.trimmed = True
            return
        allflag = 0 if (self.allarr & model.DB_ALL) else model.DB_BEST
        flags = self.reads["flags"]
        keep = ((flags & model.DB_BEST) >= allflag) \
            & (self.reads["rlen"] >= self.cutoff)

        # CCS chain rewrite (DB.c:1010-1028): a retained read keeps DB_CCS
        # only if the previous retained read was part of the same chain
        # (css resets whenever an original record lacked DB_CCS)
        kept = self.reads[keep].copy()
        if len(kept):
            idx = np.flatnonzero(keep)
            css = np.zeros(len(idx), bool)
            # css is 1 for a kept read unless some read since the previous
            # kept one (inclusive of itself) had DB_CCS == 0
            had_break = (flags & model.DB_CCS) == 0
            brk_cum = np.cumsum(had_break)
            prev_idx = np.concatenate([[-1], idx[:-1]])
            css = (brk_cum[idx] - np.where(prev_idx >= 0, brk_cum[prev_idx], 0)) == 0
            css[0] = False
            kept["flags"] = np.where(
                css, kept["flags"] | model.DB_CCS,
                kept["flags"] & ~np.int32(model.DB_CCS))
        if self._qv is not None:
            self._qv.table = self._qv.table[keep]
        if self._aoff is not None:
            self._aoff = self._aoff[keep]
        self.reads = kept
        self.trimmed = True

    # -- sequence loading ---------------------------------------------

    def load_read(self, i: int, ascii_mode: int = 0) -> bytes | np.ndarray:
        """Load_Read (DB.c:1232-1310): numeric codes (0), lower (1), upper (2)."""
        r = self.reads[i]
        rlen = int(r["rlen"])
        clen = (rlen + 3) >> 2
        with open(self.path + ".bps", "rb") as f:
            f.seek(int(r["boff"]))
            payload = np.frombuffer(f.read(clen), np.uint8)
        codes = tb.unpack_2bit_np(payload[None, :])[0, :rlen]
        if ascii_mode == 1:
            return tb.LOWER_LUT[codes].tobytes()
        if ascii_mode == 2:
            return tb.UPPER_LUT[codes].tobytes()
        return codes

    def load_subread(self, i: int, beg: int, end: int,
                     ascii_mode: int = 0) -> bytes | np.ndarray:
        """Load_Subread (DB.c:1351-1441): bases [beg, end) of read i via
        sub-byte offset math — only ceil((end-beg+3)/4)+1 payload bytes are
        touched, not the whole read."""
        r = self.reads[i]
        bb = beg >> 2
        eb = (end + 3) >> 2
        with open(self.path + ".bps", "rb") as f:
            f.seek(int(r["boff"]) + bb)
            payload = np.frombuffer(f.read(eb - bb), np.uint8)
        codes = tb.unpack_2bit_np(payload[None, :])[0]
        codes = codes[beg - 4 * bb: beg - 4 * bb + (end - beg)]
        if ascii_mode == 1:
            return tb.LOWER_LUT[codes].tobytes()
        if ascii_mode == 2:
            return tb.UPPER_LUT[codes].tobytes()
        return codes

    def sizeof(self) -> int:
        """Approximate in-memory footprint (reference sizeof_DB,
        DB.c:1044-1076)."""
        s = int(self.header.nbytes) + int(self.reads.nbytes)
        if self._qv is not None:
            s += int(self._qv.table.nbytes) + int(self._qv.data.nbytes)
        if self._aoff is not None:
            s += int(self._aoff.nbytes)
        for t in getattr(self, "track_list", []):
            s += t.nbytes()
        return s

    def load_all_reads(self):
        """Columnar batch: (payload rows padded per read, lengths)."""
        rlens = self.reads["rlen"].astype(np.int64)
        clens = (rlens + 3) >> 2
        with open(self.path + ".bps", "rb") as f:
            flat = np.frombuffer(f.read(), np.uint8)
        payload = flat_gather_lens(flat, self.reads["boff"].astype(np.int64), clens)
        return payload, rlens

    # -- arrow ---------------------------------------------------------

    _aoff: np.ndarray | None = None

    def open_arrow(self) -> None:
        """Open_Arrow (DB.c:1458-1506): arrow offsets == boff (same packing)."""
        if not self.is_arrow:
            raise DextractorError("this is not an Arrow DB")
        self._aoff = self.reads["boff"].astype(np.int64).copy()

    def load_arrow(self, i: int, ascii_mode: bool = False):
        r = self.reads[i]
        rlen = int(r["rlen"])
        clen = (rlen + 3) >> 2
        with open(self.path + ".arw", "rb") as f:
            f.seek(int(self._aoff[i] if self._aoff is not None else r["boff"]))
            payload = np.frombuffer(f.read(clen), np.uint8)
        codes = tb.unpack_2bit_np(payload[None, :])[0, :rlen]
        if ascii_mode:
            return tb.ARROW_LETTER_LUT[codes].tobytes()
        return codes

    def load_all_arrows(self, ascii_mode: bool = False):
        """Load_All_Arrows (DB.c:1570-1632), batched: all pulse streams.

        Returns (symbols (N, Lpad) u8, lengths)."""
        from ..formats.ragged import pad_rows

        rlens = self.reads["rlen"].astype(np.int64)
        clens = (rlens + 3) >> 2
        offs = (self._aoff if self._aoff is not None
                else self.reads["boff"].astype(np.int64))
        with open(self.path + ".arw", "rb") as f:
            flat = np.frombuffer(f.read(), np.uint8)
        payload = flat_gather_lens(flat, offs, clens)
        rows = pad_rows(payload, clens, align=128)
        codes = tb.unpack_2bit_np(rows)
        if ascii_mode:
            return tb.ARROW_LETTER_LUT[codes], rlens
        return codes, rlens

    def snrs(self) -> np.ndarray:
        """Per-read 4xSNR (value*100 as uint16) from the coff field."""
        return model.unpack_snr_coff(self.reads["coff"])

    # -- QVs -----------------------------------------------------------

    def open_qvs(self) -> None:
        """Open_QVs (DB.c:2324-2554): per-cell coding tables + read->scheme
        mapping; the first read of each cell has its coff advanced past the
        serialized coding."""
        if self._qv is not None:
            return
        if self.trimmed:
            raise DextractorError("Cannot load QVs after trimming the DB")
        if self.nreads and int(self.reads["coff"][-1]) < 0:
            raise DextractorError("All QVs for this DB have not been added!")

        stub = stub_mod.read_stub(self.stub_path)
        with open(self.path + ".qvs", "rb") as f:
            qdata = f.read()
        mv = memoryview(qdata)

        codings = []
        table = np.zeros(self.nreads, np.uint16)
        pfirst = self.ufirst
        plast = pfirst + self.nreads
        first = 0
        ci = 0
        for cell in range(stub.nfiles):
            last = stub.nreads[cell]
            if last <= pfirst or first >= plast:
                first = last
                continue
            if first < pfirst:
                # scheme offset lives in a record outside this block
                with open(self.path + ".idx", "rb") as f:
                    f.seek(model.DB_DTYPE.itemsize
                           + model.READ_DTYPE.itemsize * first)
                    rec = np.frombuffer(f.read(model.READ_DTYPE.itemsize),
                                        model.READ_DTYPE)
                coff = int(rec["coff"][0])
            else:
                coff = int(self.reads["coff"][first - pfirst])
            coding, end = dq.parse_qvcoding(mv, coff)
            if first >= pfirst:
                self.reads["coff"][first - pfirst] = end
            codings.append(coding)
            j = max(first - pfirst, 0)
            k = min(last - pfirst, self.nreads)
            table[j:k] = ci
            ci += 1
            first = last

        class _QV:
            pass

        qv = _QV()
        qv.codings = codings
        qv.table = table
        qv.data = np.frombuffer(qdata, np.uint8)
        self._qv = qv

    def load_all_qventries(self, ascii_mode: int = 1, device=None, mesh=None):
        """Batch-decode every read's five QV streams on the device: reads
        are independent chains (the DB stores per-read stream offsets, so
        no sequential walk is needed).

        ``device`` follows ``utils/dispatch.resolve_device``: None takes
        the card when CUDA is present (``DXT_DEVICE`` honoured), a string
        or torch.device is taken as given ("cpu" runs the kernels' plain
        twins), and a CUDA request without CUDA raises.  Where the caller
        asks for the host path (``device=False``, or ``DXT_DEVICE=0``), the
        same routes run on the twins on the CPU, as the JAX package runs
        its XLA chains on its CPU.

        Default route: per coding cell, the fused five-channel step
        (codecs/qv_batch.fused_decode_entries: K4a, K5, K6) over dense
        channel rectangles, with long reads checkpoint-segmented
        (fused_decode_entries_seg) so per-read cost does not depend on
        length (the reference envelope, QV.c:757-783).  Channel boundaries
        and checkpoints come from the ``qvchk`` track dex2DB writes
        (db/qvtrack.py) or, when absent, from a native headerless lens walk
        of the .qvs payload.  Without either, or with DXT_DB_FUSED=0, the
        per-scheme route (codecs/qv_batch.batch_decode_entries: K4b, K5,
        K6) decodes every cell in one call.  With ``mesh``
        (parallel/mesh.py), both routes split their reads over its shards
        on the mesh's device; a ``device`` that disagrees raises.

        Returns (streams (5, total) u8, lengths (N,)).
        """
        from ..formats.ragged import rows_to_flat
        from ..codecs.qv_batch import batch_decode_entries
        from ..parallel.mesh import check_device
        from ..utils.dispatch import resolve_device

        qv = self._qv
        if qv is None:
            raise DextractorError("QV's have not been opened (load_all_qventries)")
        if mesh is not None:
            dev = check_device(mesh, None if device is None else
                               resolve_device(device) or torch.device("cpu"))
        else:
            dev = resolve_device(device) or torch.device("cpu")
        rlens = self.reads["rlen"].astype(np.int32)
        starts = self.reads["coff"].astype(np.int64)
        rlens64 = rlens.astype(np.int64)
        if os.environ.get("DXT_DB_FUSED", "1") == "1":
            flats = self._load_qv_fused(starts, rlens, ascii_mode, dev, mesh)
            if flats is not None:
                return flats, rlens64
        out, rlens64 = batch_decode_entries(
            qv.data, starts, rlens, qv.codings, qv.table,
            ascii_mode=ascii_mode, device=dev, mesh=mesh)
        with stage("D2H+flat"):
            streams = np.stack([rows_to_flat(out[s], rlens64)
                                for s in range(5)])
        return streams, rlens64

    def _load_qv_fused(self, starts, rlens, ascii_mode, device, mesh=None):
        """Per-cell fused (and checkpoint-segmented) QV decode, or None
        when the index (track or native walk) is unavailable."""
        from ..formats.ragged import rows_to_flat
        from ..codecs.qv_batch import (
            fused_decode_entries, fused_decode_entries_seg)
        from ..codecs.qv_codec import SEG_DECODE
        from . import qvtrack

        qv = self._qv
        n = self.nreads
        with stage("qvchk track"):
            trk = qvtrack.load_qvchk(self)
        rl64 = rlens.astype(np.int64)
        parts = [[] for _ in range(5)]
        for ci, sl in qvtrack._cell_groups(qv, n):
            coding = qv.codings[ci]
            rl_c = rl64[sl]
            if trk is not None:
                seg, coffs, ntoks, nb, ckb, ckt, ckc = trk
                coffs_c, ntoks_c = coffs[sl], ntoks[sl]
                nb_c = nb[sl]
                ck = None
                if nb_c.sum():
                    cko_full = np.zeros(len(nb) + 1, np.int64)
                    np.cumsum(nb, out=cko_full[1:])
                    b0, b1 = int(cko_full[sl.start]), int(cko_full[sl.stop])
                    cko = np.zeros(len(rl_c) + 1, np.int64)
                    np.cumsum(nb_c, out=cko[1:])
                    ck = (seg, cko, ckb[:, b0:b1], ckt[:, b0:b1],
                          ckc[:, b0:b1])
            else:
                with stage("index walk"):
                    got = qvtrack.index_cell(qv.data, coding, starts[sl],
                                             rl_c, SEG_DECODE)
                if got is None:
                    return None
                coffs_c, ntoks_c, ck = got
            if ck is not None:
                rows = fused_decode_entries_seg(
                    qv.data, starts[sl], rl_c.astype(np.int32), coffs_c,
                    ntoks_c, coding, ck, device, mesh)
            else:
                rows = fused_decode_entries(
                    qv.data, starts[sl], rl_c.astype(np.int32), coffs_c,
                    ntoks_c, coding, device, mesh)
            with stage("D2H+flat"):
                if ascii_mode == 2:
                    rows[1] = rows[1] - 32
                elif ascii_mode == 0:
                    rows[1] = tb.NUMBER_BASE_LUT[rows[1]]
                for s in range(5):
                    parts[s].append(rows_to_flat(rows[s], rl_c))
        return np.stack([np.concatenate(p) if p else np.empty(0, np.uint8)
                         for p in parts])

    def load_qventry(self, i: int, ascii_mode: int = 1) -> np.ndarray:
        """Load_QVentry (DB.c:2575-2621) -> (5, rlen) u8 streams.

        ascii_mode per the reference: 1 = deltag lowercase ascii, 2 = upper,
        0 = numeric deltag codes.
        """
        from ..codecs.qv_codec import decode_entry

        r = self.reads[i]
        rlen = int(r["rlen"])
        coding = self._qv.codings[self._qv.table[i]]
        entry, _ = decode_entry(coding, self._qv.data, int(r["coff"]), rlen)
        if ascii_mode == 2:
            entry = entry.copy()
            entry[1] = entry[1] - 32
        elif ascii_mode == 0:
            entry = entry.copy()
            entry[1] = tb.NUMBER_BASE_LUT[entry[1]]
        return entry


def open_db(path: str) -> DazzDB:
    """Open_DB (DB.c:690-901): whole DB or a block part ``root.N``."""
    pwd = path_to(path)
    root = rootof(path, ".db")

    part = 0
    m = re.match(r"^(.*)\.(\d+)$", root)
    if m and int(m.group(2)) != 0:
        part = int(m.group(2))
        root = m.group(1)

    stub_path = catenate(pwd, "/", root, ".db")
    if not os.path.exists(stub_path):
        raise DextractorError(f"Could not open DB {path}")
    stub = stub_mod.read_stub(stub_path)

    # absolutize so later lazy file access survives cwd changes
    stub_path = os.path.abspath(stub_path)
    pwd = os.path.dirname(stub_path)
    base = binary_base(pwd, root)

    with open(base + ".idx", "rb") as f:
        header = np.frombuffer(f.read(model.DB_DTYPE.itemsize),
                               model.DB_DTYPE).copy()
        if part > 0:
            if not stub.partitioned or part > stub.nblocks:
                raise DextractorError(
                    f"DB {root} has only {stub.nblocks} blocks")
            ufirst = stub.ublocks[part - 1]
            ulast = stub.ublocks[part]
            tfirst = stub.tblocks[part - 1]
            f.seek(model.DB_DTYPE.itemsize
                   + model.READ_DTYPE.itemsize * ufirst)
            reads = np.frombuffer(
                f.read(model.READ_DTYPE.itemsize * (ulast - ufirst)),
                model.READ_DTYPE).copy()
            header["maxlen"] = reads["rlen"].max(initial=0)
            header["totlen"] = int(reads["rlen"].sum())
        else:
            ufirst = tfirst = 0
            reads = np.frombuffer(f.read(), model.READ_DTYPE).copy()

    db = DazzDB(path=base, stub_path=stub_path, header=header, reads=reads,
                part=part, ufirst=ufirst, tfirst=tfirst)
    db.cutoff = stub.cutoff if stub.partitioned else 0
    db.allarr = int(header["allarr"][0]) | (stub.all if stub.partitioned
                                            else model.DB_ALL)
    return db


def list_db_files(path: str):
    """List_DB_Files (DB.c:1089-1162): every file of the DB family."""
    pwd = path_to(path)
    root = rootof(path, ".db")
    out = [catenate(pwd, "/", root, ".db")]
    for prefix in (catenate(pwd, "/.", root, ""), catenate(pwd, "/", root, "")):
        for suf in (".idx", ".bps", ".qvs", ".arw"):
            if os.path.exists(prefix + suf):
                out.append(prefix + suf)
        d = pwd or "."
        base = os.path.basename(prefix)
        for fn in sorted(os.listdir(d)):
            if fn.startswith(base + ".") and (fn.endswith(".anno") or fn.endswith(".data")):
                out.append(os.path.join(pwd, fn))
        if len(out) > 1:
            break
    return out
