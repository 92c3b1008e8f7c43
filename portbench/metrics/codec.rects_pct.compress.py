"""Share of a compress's window, in %, in the encode's host rectangles: the
``device: rects`` spans (codecs/qv_codec.py)."""
from core.formulas import span_share


def read(ctx):
    return span_share(ctx, ("device: rects",))
