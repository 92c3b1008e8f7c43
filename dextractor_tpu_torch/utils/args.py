"""CLI argument handling with the reference's single-letter flag semantics.

The reference parses flags with the ARG_INIT/ARG_FLAGS macro family
(reference DB.h:79-123): boolean single-letter flags may be ganged ("-vk").
The port's own copy of ``dextractor_tpu/utils/args.py``, cut to the boolean
flags that the ported tools take.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


@dataclass
class ArgSpec:
    prog: str
    usage: str
    flags: str = ""              # ganged boolean flag letters, e.g. "vkl"
    help_lines: tuple = ()


def usage_exit(spec: ArgSpec) -> None:
    sys.stderr.write(f"Usage: {spec.prog} {spec.usage}\n")
    if spec.help_lines:
        sys.stderr.write("\n")
        for line in spec.help_lines:
            sys.stderr.write(f"      {line}\n")
    raise SystemExit(1)


def parse_flags(spec: ArgSpec, argv: list[str]):
    """Return (flags: dict[letter, bool], positional)."""
    flags = {c: False for c in spec.flags}
    positional = []
    for arg in argv:
        if arg.startswith("-") and len(arg) > 1:
            for ch in arg[1:]:
                if ch not in flags:
                    sys.stderr.write(f"{spec.prog}: -{ch} is an illegal option\n")
                    usage_exit(spec)
                flags[ch] = True
        else:
            positional.append(arg)
    return flags, positional
