"""undexar — uncompress .dexar back to .arrow (reference undexar.c)."""

from __future__ import annotations

import sys

from ..codecs.twobit_codec import decode_dexar_to_arrow
from ._common import codec_tool

USAGE = "[-vk] [-w<int(80)>] ( -i | <path:dexar> ... )"
HELP = (
    "-i: source is on standard input.",
    "-k: do *not* remove the .dexar file on completion.",
    "-w: line width for sequence lines.",
)


def main(argv=None) -> int:
    return codec_tool(
        "undexar", USAGE, HELP, ".dexar", ".arrow",
        lambda data, flags, opts: decode_dexar_to_arrow(data, width=opts["w"]),
        "vki", int_opts={"w": ("Line width", 80, 0)}, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
