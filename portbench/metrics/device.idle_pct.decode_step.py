"""Share, in %, of the traced window in which no operation ran on the card, in
the segmented decode step, called back to back."""
from core.formulas import idle_pct


def read(ctx):
    return idle_pct(ctx)
