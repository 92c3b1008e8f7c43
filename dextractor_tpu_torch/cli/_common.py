"""Shared CLI plumbing for the codec tools (the port's copy of
``dextractor_tpu/cli/_common.py``)."""

from __future__ import annotations

import os
import sys

from ..utils.args import ArgSpec, parse_flags, usage_exit
from ..utils.errors import DextractorError
from ..utils.paths import path_to, root, catenate


def codec_tool(prog, usage, help_lines, in_suffix, out_suffix, transform,
               flags_str, int_opts=None, argv=None):
    """Run a compress/uncompress tool over its file arguments.

    ``transform(data: bytes, flags, opts) -> bytes`` transforms one file
    image.  Mirrors the per-file loop of the reference tools: resolve
    pwd/root, transform, write sibling output, delete the source unless
    ``-k`` (dexqv.c, undexqv.c).  A tool whose ``flags_str`` holds ``i``
    takes ``-i``: stdin to stdout, no file arguments, ``-k`` implied
    (dexta.c:72-217).
    """
    from ..utils.profiling import REPORTER

    spec = ArgSpec(prog=prog, usage=usage, flags=flags_str,
                   int_opts=int_opts or {}, help_lines=help_lines)
    flags, opts, files = parse_flags(spec, argv if argv is not None else sys.argv[1:])
    # -v turns on the per-stage throughput table (SURVEY §5: the
    # reference's only introspection is per-file progress; the framework
    # adds parse/scan/encode/assemble GB/s counters, printed at exit)
    REPORTER.enabled = bool(flags.get("v"))
    REPORTER.stages.clear()
    pipe = flags.get("i", False)
    if pipe == bool(files):
        usage_exit(spec)
    if pipe:
        flags["k"] = True
        try:
            out = transform(sys.stdin.buffer.read(), flags, opts)
        except DextractorError as e:
            sys.stderr.write(f"{prog}: {e}\n")
            return 1
        sys.stdout.buffer.write(out)
        REPORTER.report()
        return 0

    for path in files:
        pwd = path_to(path)
        base = root(path, in_suffix)
        src = catenate(pwd, "/", base, in_suffix)
        dst = catenate(pwd, "/", base, out_suffix)
        if flags.get("v"):
            sys.stderr.write(f"Processing '{base}' ...\n")
        try:
            with open(src, "rb") as f:
                data = f.read()
        except OSError as e:
            sys.stderr.write(f"{prog}: Cannot open {src}: {e.strerror}\n")
            return 1
        try:
            out = transform(data, flags, opts)
        except DextractorError as e:
            sys.stderr.write(f"{prog}: {e}\n")
            return 1
        tmp = dst + ".part"
        with open(tmp, "wb") as f:
            f.write(out)
        os.replace(tmp, dst)
        if not flags.get("k"):
            os.unlink(src)
        if flags.get("v"):
            sys.stderr.write("Done\n")
    REPORTER.report()
    return 0
