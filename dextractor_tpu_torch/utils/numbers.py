"""Big-number pretty printing (reference Print_Number / Number_Digits,
DB.c:253-308): comma-separated thousands, right-aligned in a width.  The
port's own copy of ``dextractor_tpu/utils/numbers.py``."""

from __future__ import annotations


def number_digits(num: int) -> int:
    """Digits in the printed (comma-free) representation (DB.c:296-308)."""
    n = abs(int(num))
    d = 1
    while n >= 10:
        n //= 10
        d += 1
    return d


def print_number(num: int, width: int = 0) -> str:
    """Comma-separated integer, right-aligned to ``width`` (DB.c:253-294)."""
    s = f"{int(num):,}"
    if width > len(s):
        s = " " * (width - len(s)) + s
    return s
