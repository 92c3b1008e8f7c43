"""Payload bytes (five a base) of whole files encoded a second, over all the
work and all the time of the window; in MB/s."""
from core.formulas import rate


def read(ctx):
    return rate(ctx, 1e6)
