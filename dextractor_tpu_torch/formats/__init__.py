"""The container formats on the host; the package exports what the JAX
package's ``formats`` does, the ragged-batch helpers."""

from .ragged import Ragged, pad_rows, rows_to_flat, flat_gather_lens
