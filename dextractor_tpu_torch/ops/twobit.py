"""2-bit base numbering tables (``dextractor_tpu/ops/twobit.py:58``).

Only the table the ``.dexqv`` encode path needs: delTag characters to their
2-bit codes (Number_Read, DB.c:289-317).
"""

from __future__ import annotations

import numpy as np


def _number_base_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)           # unknown chars -> 0 ('a')
    for i, ch in enumerate(b"acgt"):
        t[ch] = i
        t[ch - 32] = i                     # uppercase
    return t


NUMBER_BASE_LUT = _number_base_table()
