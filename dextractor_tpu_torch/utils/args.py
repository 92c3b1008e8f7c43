"""CLI argument handling with the reference's single-letter flag semantics.

The reference parses flags with the ARG_INIT/ARG_FLAGS/ARG_NON_NEGATIVE
macro family (reference DB.h:79-123): boolean single-letter flags may be
ganged ("-vk"), a value option takes its value right after the letter
("-w80", "-ofile", "-e'expr'").  The port's own copy of
``dextractor_tpu/utils/args.py``, cut to the boolean flags, integer options
and string options that the ported tools take.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class ArgSpec:
    prog: str
    usage: str
    flags: str = ""              # ganged boolean flag letters, e.g. "vki"
    int_opts: dict = field(default_factory=dict)    # letter -> (name, default, min)
    str_opts: dict = field(default_factory=dict)    # letter -> default
    help_lines: tuple = ()


class ArgError(SystemExit):
    """A malformed option value: exits 1 after its message."""


def usage_exit(spec: ArgSpec) -> None:
    sys.stderr.write(f"Usage: {spec.prog} {spec.usage}\n")
    if spec.help_lines:
        sys.stderr.write("\n")
        for line in spec.help_lines:
            sys.stderr.write(f"      {line}\n")
    raise SystemExit(1)


def parse_flags(spec: ArgSpec, argv: list[str]):
    """Return (flags: dict[letter, bool], opts: dict[letter, int or str],
    positional)."""
    flags = {c: False for c in spec.flags}
    opts = {letter: default for letter, (_, default, _) in spec.int_opts.items()}
    opts.update(spec.str_opts)
    positional = []
    for arg in argv:
        if arg.startswith("-") and len(arg) > 1:
            c = arg[1]
            if c in spec.int_opts:
                name, _, minv = spec.int_opts[c]
                try:
                    v = int(arg[2:])
                except ValueError:
                    sys.stderr.write(f"{spec.prog}: -{c} '{arg[2:]}' argument is not "
                                     "an integer\n")
                    raise ArgError(1)
                if v < minv:
                    kind = "positive" if minv > 0 else "non-negative"
                    sys.stderr.write(f"{spec.prog}: {name} must be {kind}\n")
                    raise ArgError(1)
                opts[c] = v
                continue
            if c in spec.str_opts:
                opts[c] = arg[2:]
                continue
            for ch in arg[1:]:
                if ch not in flags:
                    sys.stderr.write(f"{spec.prog}: -{ch} is an illegal option\n")
                    usage_exit(spec)
                flags[ch] = True
        else:
            positional.append(arg)
    return flags, opts, positional
