"""Host-clock ms a call of the encode step takes to return (its enqueue)."""
from core.formulas import host_ms


def read(ctx):
    return host_ms(ctx)
