"""The library entry points of the codecs; the package exports what the
JAX package's ``codecs`` does, the 2-bit codecs (``.dexqv`` is in
``codecs.qv_codec``)."""

from .twobit_codec import (
    encode_fasta_to_dexta,
    decode_dexta_to_fasta,
    encode_arrow_to_dexar,
    decode_dexar_to_arrow,
)
