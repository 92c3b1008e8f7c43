"""Path helpers with the semantics of the reference utilities.

Mirrors the behavior of PathTo/Root/Catenate/Numbered_Suffix (reference
DB.c:171-246) so CLI tools resolve arguments identically: ``root`` strips a
trailing suffix only if it matches.  The port's own copy of ``dextractor_tpu/utils/paths.py``.
"""

from __future__ import annotations

import os


def path_to(path: str) -> str:
    """Directory part of ``path`` ('.' if none). Reference DB.c:171-186."""
    d = os.path.dirname(path)
    return d if d else "."


def root(path: str, suffix: str) -> str:
    """Base name of ``path`` with ``suffix`` removed if present.

    Reference DB.c:188-216: finds the last '.'-separated suffix of the
    final path component and strips it only when it equals ``suffix``.
    """
    base = os.path.basename(path)
    if suffix and base.endswith(suffix):
        return base[: -len(suffix)]
    return base


def catenate(*parts: str) -> str:
    """String concatenation (reference Catenate DB.c:218-234)."""
    return "".join(p for p in parts if p)


def numbered_suffix(left: str, num: int, right: str) -> str:
    """'left<num>right' (reference Numbered_Suffix DB.c:236-246)."""
    return f"{left}{num}{right}"
