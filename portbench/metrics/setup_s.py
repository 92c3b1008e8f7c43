"""Seconds from the start of the process to the window: imports, the card,
the files, the program's own preparation of a step's arguments, its kernel
build where it is not cached yet, and the warm-up.  The reference's encodes
of a decode cell's inputs are the benchmark's work and are left out."""


def read(ctx):
    return ctx["setup_s"]
