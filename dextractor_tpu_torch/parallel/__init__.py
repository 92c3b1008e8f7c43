"""The sharded pipeline (``dextractor_tpu/parallel``): the data mesh, the
process group and the sharded steps.  The JAX package's ``data_sharding``
(a NamedSharding that places an array's blocks on the mesh) has its
counterpart in ``multihost.mesh_put``, which moves each shard's block of
reads to its device."""

from .mesh import Mesh, make_mesh
from .multihost import mesh_put
from .pipeline import (
    null_run_luts,
    qv_encode_step,
    qv_scan_step,
    sharded_qv_encode,
    sharded_qv_scan,
    sharded_twobit_decode,
    sharded_twobit_encode,
)
