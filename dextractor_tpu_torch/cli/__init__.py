"""Command-line tools of the port, mirroring the reference suite.

Each tool is runnable as ``python -m dextractor_tpu_torch <tool>``.  Six of
the reference's eight are ported; ``dextract`` and ``dex2DB`` are not yet.
"""

from __future__ import annotations

import sys

TOOLS = ("dexta", "undexta", "dexar", "undexar", "dexqv", "undexqv")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        sys.stderr.write("usage: dextractor_tpu_torch <tool> [args]\n"
                         f"  tools: {', '.join(TOOLS)}\n")
        return 1
    import importlib

    mod = importlib.import_module(f".{argv[0]}", __package__)
    return mod.main(argv[1:])
