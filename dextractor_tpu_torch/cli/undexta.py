"""undexta — uncompress .dexta back to .fasta (reference undexta.c)."""

from __future__ import annotations

import sys

from ..codecs.twobit_codec import decode_dexta_to_fasta
from ._common import codec_tool

USAGE = "[-vkU] [-w<int(80)>] ( -i | <path:dexta> ... )"
HELP = (
    "-i: source is on standard input.",
    "-k: do *not* remove the .dexta file on completion.",
    "-U: use uppercase letters (default is lower case).",
    "-w: line width for sequence lines.",
)


def main(argv=None) -> int:
    return codec_tool(
        "undexta", USAGE, HELP, ".dexta", ".fasta",
        lambda data, flags, opts: decode_dexta_to_fasta(
            data, width=opts["w"], upper=flags["U"]),
        "vkiU", int_opts={"w": ("Line width", 80, 0)}, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
