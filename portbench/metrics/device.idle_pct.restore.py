"""Share, in %, of the traced window in which no operation ran on the card, in
whole-file decodes."""
from core.formulas import idle_pct


def read(ctx):
    return idle_pct(ctx)
