"""The decode step's share, in %, of the card's memory roofline: the bytes it
has to move at the least over the published HBM bandwidth, against the
card's busy seconds in the traced part."""
from core.formulas import roofline


def read(ctx):
    return roofline(ctx)
