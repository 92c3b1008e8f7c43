"""dextract — extract .fasta/.arrow/.quiva from PacBio instrument files.

Mirrors dextract.c:166-498: suffix sniffing (.subreads.bam, .subreads.sam,
.bax.h5), -vfaq output selection (fasta default), -o output naming (bare -o
= stdout, single stream only), -e filter DSL (default "ln>=500 && rq>=750"),
and unlink-partial-outputs-on-error.  Host code only.  The port's own copy of
``dextractor_tpu/cli/dextract.py``.
"""

from __future__ import annotations

import os
import sys

from ..utils.args import ArgSpec, parse_flags, usage_exit
from ..utils.errors import DextractorError
from ..utils.paths import path_to, root, catenate
from ..ingest.filter import parse_filter, FilterError, DEFAULT_FILTER
from ..ingest import extract as ex

USAGE = "[-vfaq] [-o[<path>]] [-e<expr(ln>=500 && rq>=750)>] <input:pacbio> ..."
HELP = (
    "-f: extract a .fasta file with Pacbio-style line headers.",
    "-a: extract a .arrow file with SNR encoded in line headers.",
    "-q: extract a .quiva file with Pacbio-style line headers.",
    "",
    "-o: If absent, output files use root name of input .bax or .bam.",
    "  : If no path given, output sent to standard output.",
    "  : If path given, output files use path name as root name.",
    "",
    "-e: subread selection expression.  Possible variables are:",
    "     zm  - well number",
    "     ln  - length of subread",
    "     rq  - quality value of subread (normalized to [0,1000])",
    "     bc1 - # of first barcode",
    "     bc2 - # of second barcode",
    "     bq  - quality of barcode detection (normalized to [0,100])",
    "     np  - number of passes producing subread",
    "     qs  - start pulse of subread",
)


def _sniff(arg: str):
    """Resolve input type by suffix probing (dextract.c:303-321)."""
    pwd = path_to(arg)
    for suffix, kind in ((".subreads.bam", "bam"), (".subreads.sam", "sam"),
                         (".bax.h5", "bax")):
        core = root(arg, suffix)
        full = catenate(pwd, "/", core, suffix)
        if os.path.exists(full):
            return pwd, core, full, kind
    core = root(arg, ".subreads.bam")
    sys.stderr.write(
        f"dextract: Cannot find {pwd}/{core} with a Pacbio extension\n")
    return None


def _extract_sam(path: str, expr, sinks):
    """Stream records from a BAM/SAM and write outputs as they pass the
    filter (the reference writes per subread, dextract.c:375-424)."""
    from ..ingest.sam import SamReader, HASQV, HASPW

    fas, arr, qvs = (sinks.get("fasta"), sinks.get("arrow"),
                     sinks.get("quiva"))
    reader = SamReader(path)
    status = reader.header_status()
    if arr is not None and not (status & HASPW):
        raise DextractorError(f"{path} does not have Arrow information")
    if qvs is not None and not (status & HASQV):
        raise DextractorError(f"{path} does not have Quiver information")

    for rec in reader:
        fields = {
            "zm": [rec.well], "ln": [rec.len],
            "rq": [int(1000 * rec.qual)], "bc1": [rec.bc[0]],
            "bc2": [rec.bc[1]], "bq": [rec.bqual], "np": [rec.nump],
            "qs": [rec.beg],
        }
        if not expr.evaluate(fields)[0]:
            continue
        qv1000 = int(rec.qual * 1000.0)
        if fas is not None:
            fas.write(ex.fasta_entry(rec.header, rec.well, rec.beg, rec.end,
                                     qv1000, rec.seq))
        if arr is not None:
            arr.write(ex.arrow_entry(rec.header, rec.snr, rec.arr))
        if qvs is not None:
            qvs.write(ex.quiva_entry(rec.header, rec.well, rec.beg, rec.end,
                                     qv1000, rec.qv))


def _extract_bax(path: str, expr, sinks):
    from ..ingest.bax import read_bax

    fas_s, arr_s, qvs_s = (sinks.get("fasta"), sinks.get("arrow"),
                           sinks.get("quiva"))
    want_fas = fas_s is not None
    want_arr = arr_s is not None
    want_qvs = qvs_s is not None
    b = read_bax(path, want_qvs, want_arr)
    fas, arr, qvs = [], [], []
    for s in b.subreads():
        fields = {
            "zm": [s.well], "ln": [s.lpulse - s.fpulse],
            "rq": [s.qv], "qs": [s.fpulse],
        }
        if not expr.evaluate(fields)[0]:
            continue
        roff = s.data_off + s.fpulse
        length = s.lpulse - s.fpulse
        if want_arr:
            snr = b.snr_vec[s.zmw_off][b.chan]
            arr.append(ex.arrow_entry(
                b.movie_name, snr,
                ex.pulses_to_chars(b.pulse_w[roff:roff + length])))
        if want_fas:
            fas.append(ex.fasta_entry(
                b.movie_name, s.well, s.fpulse, s.lpulse, s.qv,
                b.base_call[roff:roff + length].tobytes(), lower=True))
        if want_qvs:
            import numpy as np
            delqv = b.del_qv[roff:roff + length]
            deltag = b.del_tag[roff:roff + length].tobytes().lower()
            # the comparison value is case-shifted like the tag
            # (dextract.c:95-101)
            d = b.del_limit
            if 65 <= d <= 90:
                d += ex.LOWER_OFFSET
            deltag = np.frombuffer(deltag, np.uint8).copy()
            deltag[delqv == d] = ord("n")
            qvs.append(ex.quiva_entry(
                b.movie_name, s.well, s.fpulse, s.lpulse, s.qv,
                [ex.phred33(delqv).tobytes(), deltag.tobytes(),
                 ex.phred33(b.ins_qv[roff:roff + length]).tobytes(),
                 ex.phred33(b.merge_qv[roff:roff + length]).tobytes(),
                 ex.phred33(b.sub_qv[roff:roff + length]).tobytes()]))
    # bax is a bulk HDF5 load (matching getBaxData, bax.c:139-274), so its
    # outputs are written in one pass per dataset
    if want_fas:
        fas_s.write(b"".join(fas))
    if want_arr:
        arr_s.write(b"".join(arr))
    if want_qvs:
        qvs_s.write(b"".join(qvs))


def main(argv=None) -> int:
    spec = ArgSpec(prog="dextract", usage=USAGE, flags="vfaq",
                   str_opts={"o": None, "e": None}, help_lines=HELP)
    flags, opts, files = parse_flags(spec, argv if argv is not None else sys.argv[1:])
    if not files:
        usage_exit(spec)

    want_fas, want_arr, want_qvs = flags["f"], flags["a"], flags["q"]
    if not (want_fas or want_arr or want_qvs):
        want_fas = True

    try:
        expr = parse_filter(opts["e"] if opts["e"] is not None else DEFAULT_FILTER)
    except FilterError as e:
        sys.stderr.write(f"dextract: {e}\n")
        return 1

    output = opts["o"]
    if output == "" and want_fas + want_arr + want_qvs > 1:
        sys.stderr.write("dextract: Cannot send more than one stream to standard output\n")
        return 1

    wanted = [(want_fas, "fasta", ".fasta"), (want_arr, "arrow", ".arrow"),
              (want_qvs, "quiva", ".quiva")]

    # -o<name>: one set of output files shared across all inputs
    agg_sinks = {}
    created = []                 # partial outputs to unlink on error
    if output:
        opath = path_to(output)
        oroot = root(output, "")
        for want, key, suf in wanted:
            if want:
                p = catenate(opath, "/", oroot, suf)
                agg_sinks[key] = open(p, "wb")
                created.append(p)

    def fail(msg=None):
        # unlink partial outputs (dextract.c:464-493); msg=None when the
        # caller already printed the reference-format diagnostic
        if msg is not None:
            sys.stderr.write(f"dextract: {msg}\n")
        for s in agg_sinks.values():
            s.close()
        for p in created:
            try:
                os.unlink(p)
            except OSError:
                pass
        return 1

    for arg in files:
        sn = _sniff(arg)
        if sn is None:
            return fail()                # _sniff printed the diagnostic
        pwd, core, full, kind = sn
        if flags["v"]:
            sys.stderr.write(f"Processing file : {core} ...\n")

        per_file = []
        if output is None:
            sinks = {}
            for want, key, suf in wanted:
                if want:
                    p = catenate(pwd, "/", core, suf)
                    sinks[key] = open(p, "wb")
                    per_file.append(p)
            created.extend(per_file)
        elif output == "":
            key = "fasta" if want_fas else "arrow" if want_arr else "quiva"
            sinks = {key: sys.stdout.buffer}
        else:
            sinks = agg_sinks

        try:
            if kind in ("bam", "sam"):
                _extract_sam(full, expr, sinks)
            else:
                _extract_bax(full, expr, sinks)
        except DextractorError as e:
            if output is None:
                for s in sinks.values():
                    s.close()
            return fail(str(e))

        if output is None:
            for s in sinks.values():
                s.close()
            # this input completed: its outputs are no longer partial
            for p in per_file:
                created.remove(p)
        if flags["v"]:
            sys.stderr.write("Done\n")

    for s in agg_sinks.values():
        s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
