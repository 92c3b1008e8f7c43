"""dexqv — compress .quiva to .dexqv (reference dexqv.c)."""

from __future__ import annotations

import sys

from ..codecs.qv_codec import encode_quiva_to_dexqv
from ._common import codec_tool

USAGE = "[-vkl] <path:quiva> ..."
HELP = (
    "-k: do *not* remove the .quiva file on completion.",
    "-l: lossy compression of the QV streams.",
)


def main(argv=None) -> int:
    return codec_tool(
        "dexqv", USAGE, HELP, ".quiva", ".dexqv",
        lambda data, flags, opts: encode_quiva_to_dexqv(data, lossy=flags["l"]),
        "vkl", argv=argv)


if __name__ == "__main__":
    sys.exit(main())
