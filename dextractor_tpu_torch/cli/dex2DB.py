"""dex2DB — build/append PacBio files into a Dazzler DB (dex2DB.c:125-1077).

Flags -vlaq, -e<filter>, -f<file-of-names>; type enforcement (S-DB/A-DB/Q-DB),
duplicate-file rejection, transactional append with rollback, atomic
.dbx -> .db commit.  The DB is built on the host (``db/build.py``).  The
port's own copy of ``dextractor_tpu/cli/dex2DB.py``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..utils.args import ArgSpec, parse_flags, usage_exit
from ..utils.errors import DextractorError
from ..utils.paths import path_to, root, catenate
from ..ingest.filter import parse_filter, FilterError, DEFAULT_FILTER
from ..db.build import DBBuilder, CellData

USAGE = ("[-vlaq] [-e<expr(ln>=500 && rq>=750)>]\n"
         "        <path:string> ( -f<file> | <input:pacbio> ... )")
HELP = (
    "-f: build or add to DB the files listed in the -f file.",
    "",
    "-a: Build or add to an arrow DB.",
    "-q: Build or add to a quiva DB.",
    "-l: Use lossy compression (with -q option only).",
    "",
    "-e: subread selection expression (see dextract).",
)


def _sniff(arg: str):
    pwd = path_to(arg)
    for suffix, kind in ((".subreads.bam", "bam"), (".subreads.sam", "sam"),
                         (".bax.h5", "bax")):
        core = root(arg, suffix)
        full = catenate(pwd, "/", core, suffix)
        if os.path.exists(full):
            return core, full, kind
    raise DextractorError(
        f"Cannot find {pwd}/{root(arg, '.subreads.bam')} with a Pacbio extension")


def _cell_from_sam(core, full, expr, want_qv, want_arrow) -> CellData:
    from ..ingest.sam import SamReader, HASQV, HASPW

    reader = SamReader(full)
    status = reader.header_status()
    if want_arrow and not (status & HASPW):
        raise DextractorError(f"{full} does not have Arrow information")
    if want_qv and not (status & HASQV):
        raise DextractorError(f"{full} does not have Quiver information")

    wells, fpulses, qv1000 = [], [], []
    seq_parts, lengths = [], []
    qv_parts = [[] for _ in range(5)]
    pulse_parts, snrs = [], []
    prolog = b"unknown"
    for rec in reader:
        fields = {"zm": [rec.well], "ln": [rec.len],
                  "rq": [int(1000 * rec.qual)], "bc1": [rec.bc[0]],
                  "bc2": [rec.bc[1]], "bq": [rec.bqual], "np": [rec.nump],
                  "qs": [rec.beg]}
        if not expr.evaluate(fields)[0]:
            continue
        prolog = rec.header
        wells.append(rec.well)
        fpulses.append(rec.beg)
        qv1000.append(int(1000.0 * rec.qual))
        seq_parts.append(np.frombuffer(rec.seq, np.uint8))
        lengths.append(rec.len)
        if want_qv:
            for k in range(5):
                qv_parts[k].append(np.frombuffer(bytes(rec.qv[k]), np.uint8))
        if want_arrow:
            # rec.arr holds chars '1'..'4' -> codes 0..3
            pulse_parts.append(np.frombuffer(rec.arr, np.uint8) - ord("1"))
            snrs.append(np.asarray(rec.snr, np.float64))

    def cat(parts):
        return np.concatenate(parts) if parts else np.empty(0, np.uint8)

    qv_streams = None
    if want_qv:
        qv_streams = np.stack([cat(p) for p in qv_parts])
    return CellData(
        core=core, prolog=prolog.decode(),
        wells=np.array(wells, np.int32), fpulses=np.array(fpulses, np.int32),
        qv1000=np.array(qv1000, np.int32), seqs=cat(seq_parts),
        lengths=np.array(lengths, np.int64), qv_streams=qv_streams,
        pulses=cat(pulse_parts) if want_arrow else None,
        snrs=np.array(snrs, np.float64) if want_arrow else None)


def _cell_from_bax(core, full, expr, want_qv, want_arrow) -> CellData:
    from ..ingest.bax import read_bax
    from ..ingest import extract as ex

    b = read_bax(full, want_qv, want_arrow)
    wells, fpulses, qv1000 = [], [], []
    seq_parts, lengths = [], []
    qv_parts = [[] for _ in range(5)]
    pulse_parts, snrs = [], []
    # the comparison value is case-shifted like the tag (dex2DB.c:529-534)
    d = b.del_limit
    if 65 <= d <= 90:
        d += 32
    for s in b.subreads():
        fields = {"zm": [s.well], "ln": [s.lpulse - s.fpulse],
                  "rq": [s.qv], "qs": [s.fpulse]}
        if not expr.evaluate(fields)[0]:
            continue
        roff = s.data_off + s.fpulse
        length = s.lpulse - s.fpulse
        wells.append(s.well)
        fpulses.append(s.fpulse)
        qv1000.append(s.qv)
        seq_parts.append(b.base_call[roff:roff + length])
        lengths.append(length)
        if want_qv:
            delqv = b.del_qv[roff:roff + length]
            deltag = np.frombuffer(
                b.del_tag[roff:roff + length].tobytes().lower(), np.uint8).copy()
            deltag[delqv == d] = ord("n")
            qv_parts[0].append(ex.phred33(delqv))
            qv_parts[1].append(deltag)
            qv_parts[2].append(ex.phred33(b.ins_qv[roff:roff + length]))
            qv_parts[3].append(ex.phred33(b.merge_qv[roff:roff + length]))
            qv_parts[4].append(ex.phred33(b.sub_qv[roff:roff + length]))
        if want_arrow:
            pw = b.pulse_w[roff:roff + length].astype(np.int64)
            pulse_parts.append((np.clip(pw, 1, 4) - 1).astype(np.uint8))
            snrs.append(b.snr_vec[s.zmw_off][b.chan].astype(np.float64))

    def cat(parts):
        return np.concatenate(parts) if parts else np.empty(0, np.uint8)

    qv_streams = np.stack([cat(p) for p in qv_parts]) if want_qv else None
    return CellData(
        core=core, prolog=b.movie_name.decode(),
        wells=np.array(wells, np.int32), fpulses=np.array(fpulses, np.int32),
        qv1000=np.array(qv1000, np.int32), seqs=cat(seq_parts),
        lengths=np.array(lengths, np.int64), qv_streams=qv_streams,
        pulses=cat(pulse_parts) if want_arrow else None,
        snrs=np.array(snrs, np.float64) if want_arrow else None)


def main(argv=None) -> int:
    spec = ArgSpec(prog="dex2DB", usage=USAGE, flags="vlaq",
                   str_opts={"e": None, "f": None}, help_lines=HELP)
    flags, opts, files = parse_flags(spec, argv if argv is not None else sys.argv[1:])

    if opts["f"] is not None:
        if len(files) != 1:
            usage_exit(spec)
        try:
            with open(opts["f"]) as f:
                inputs = [l.strip() for l in f if l.strip()]
        except OSError:
            sys.stderr.write(f"dex2DB: Cannot open file of inputs '{opts['f']}'\n")
            return 1
    else:
        if len(files) < 2:
            usage_exit(spec)
        inputs = files[1:]

    if flags["a"] and flags["q"]:
        sys.stderr.write("dex2DB: Cannot set both -a(rrow) and -q(uiver)\n")
        return 1

    try:
        expr = parse_filter(opts["e"] if opts["e"] is not None else DEFAULT_FILTER)
    except FilterError as e:
        sys.stderr.write(f"dex2DB: {e}\n")
        return 1

    if not flags["q"] and flags["l"]:
        sys.stderr.write(
            "dex2DB: Warning: Option -l set but not adding Quiver information?\n")

    builder = None
    try:
        builder = DBBuilder(files[0], arrow=flags["a"], quiver=flags["q"],
                            lossy=flags["l"], verbose=flags["v"])
        for arg in inputs:
            core, full, kind = _sniff(arg)
            if os.path.getsize(full) == 0:
                sys.stderr.write(f"Skipping '{core}', file is empty!\n")
                continue
            if flags["v"]:
                sys.stderr.write(f"Adding '{core}' ...\n")
            if kind in ("bam", "sam"):
                cell = _cell_from_sam(core, full, expr, builder.quiver,
                                      builder.arrow)
            else:
                cell = _cell_from_bax(core, full, expr, builder.quiver,
                                      builder.arrow)
            builder.add_cell(cell)
        builder.finalize()
    except DextractorError as e:
        sys.stderr.write(f"dex2DB: {e}\n")
        if builder is not None:
            builder.rollback()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
