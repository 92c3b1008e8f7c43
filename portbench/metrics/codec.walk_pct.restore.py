"""Share of a restore's window, in %, in the native lens walks that find every
entry's channel offsets and the segment checkpoints: the ``index walk`` and
``checkpoint walk`` spans (codecs/qv_codec.py)."""
from core.formulas import span_share


def read(ctx):
    return span_share(ctx, ("index walk", "checkpoint walk"))
