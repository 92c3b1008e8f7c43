"""Share of a restore's window, in %, in the copy of whole padded rows to
the host and their compaction: the ``D2H+flat`` spans (codecs/qv_batch.py)."""
from core.formulas import span_share


def read(ctx):
    return span_share(ctx, ("D2H+flat",))
