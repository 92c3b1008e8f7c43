"""undexqv — uncompress .dexqv back to .quiva (reference undexqv.c)."""

from __future__ import annotations

import sys

from ..codecs.qv_codec import decode_dexqv_to_quiva
from ._common import codec_tool

USAGE = "[-vkU] <path:dexqv> ..."
HELP = (
    "-k: do *not* remove the .dexqv file on completion.",
    "-U: use uppercase letters (default is lower case).",
)


def main(argv=None) -> int:
    return codec_tool(
        "undexqv", USAGE, HELP, ".dexqv", ".quiva",
        lambda data, flags, opts: decode_dexqv_to_quiva(data, upper=flags["U"]),
        "vkU", argv=argv)


if __name__ == "__main__":
    sys.exit(main())
