"""Share, in %, of the encode step's device time in the program's own kernels."""
from core.formulas import own_kernel_pct


def read(ctx):
    return own_kernel_pct(ctx)
