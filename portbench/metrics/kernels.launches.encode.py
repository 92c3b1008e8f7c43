"""Launches of the program's own kernels a call of the encode step."""
from core.formulas import launches_per_call


def read(ctx):
    return launches_per_call(ctx)
