"""Error model.

The reference compiles an INTERACTIVE switch that routes errors either to a
buffer-and-return or stderr-and-exit (reference DB.h:26-49).  Here the library
always *raises* ``DextractorError`` and only the CLI layer converts it into a
process exit — the Pythonic equivalent of the batch mode.
"""


class DextractorError(RuntimeError):
    """Any format/IO violation detected by the framework."""


class FormatError(DextractorError):
    """A container or text file violates its format contract."""
