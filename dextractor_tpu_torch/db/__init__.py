"""The Dazzler DB library (``dextractor_tpu/db/``): the stub and .idx
records, tracks, block arguments, the dex2DB builder and the ``qvchk`` QV
index track, all on the host, and ``DazzDB.load_all_qventries``, which
decodes the QV streams on the device."""

from .model import READ_DTYPE, DB_DTYPE, DB_QV, DB_CCS, DB_BEST, DB_ARROW, DB_ALL
from .stub import Stub, read_stub, write_stub, fetch_block_range
from .access import DazzDB, open_db, list_db_files
from .blocks import BlockLooper, parse_block_db_arg, parse_block_las_arg
