"""dexta — compress .fasta to .dexta (reference dexta.c)."""

from __future__ import annotations

import sys

from ..codecs.twobit_codec import encode_fasta_to_dexta
from ._common import codec_tool

USAGE = "[-vk] ( -i | <path:fasta> ... )"
HELP = (
    "-i: source is on standard input.",
    "-k: do *not* remove the .fasta file on completion.",
)


def main(argv=None) -> int:
    return codec_tool(
        "dexta", USAGE, HELP, ".fasta", ".dexta",
        lambda data, flags, opts: encode_fasta_to_dexta(data),
        "vki", argv=argv)


if __name__ == "__main__":
    sys.exit(main())
