"""Payload bytes (five a base) through the segmented decode step a second:
every step enqueued in the window, which closes with one synchronisation;
in GB/s."""
from core.formulas import rate


def read(ctx):
    return rate(ctx, 1e9)
