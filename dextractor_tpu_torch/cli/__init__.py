"""Command-line tools of the port, mirroring the reference suite.

Each tool is runnable as ``python -m dextractor_tpu_torch <tool>``: all
eight of the reference suite, the ``.dexqv`` and 2-bit codecs, ``dextract``
(PacBio BAM/SAM/.bax.h5 to .fasta/.arrow/.quiva) and ``dex2DB`` (a Dazzler
DB from the same inputs).
"""

from __future__ import annotations

import sys

TOOLS = ("dexta", "undexta", "dexar", "undexar", "dexqv", "undexqv",
         "dextract", "dex2DB")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        sys.stderr.write("usage: dextractor_tpu_torch <tool> [args]\n"
                         f"  tools: {', '.join(TOOLS)}\n")
        return 1
    import importlib

    mod = importlib.import_module(f".{argv[0]}", __package__)
    return mod.main(argv[1:])
