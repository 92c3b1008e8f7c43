"""dexar — compress .arrow to .dexar (reference dexar.c)."""

from __future__ import annotations

import sys

from ..codecs.twobit_codec import encode_arrow_to_dexar
from ._common import codec_tool

USAGE = "[-vk] ( -i | <path:arrow> ... )"
HELP = (
    "-i: source is on standard input.",
    "-k: do *not* remove the .arrow file on completion.",
)


def main(argv=None) -> int:
    return codec_tool(
        "dexar", USAGE, HELP, ".arrow", ".dexar",
        lambda data, flags, opts: encode_arrow_to_dexar(data),
        "vki", argv=argv)


if __name__ == "__main__":
    sys.exit(main())
