"""The port's device ops and their kernels' wrappers; the package exports
what the JAX package's ``ops`` does, the 2-bit tables and ops."""

from .twobit import (
    NUMBER_BASE_LUT,
    NUMBER_ARROW_LUT,
    LOWER_LUT,
    UPPER_LUT,
    ARROW_LETTER_LUT,
    compressed_len,
    pack_2bit_np,
    unpack_2bit_np,
    pack_2bit,
    unpack_2bit,
)
