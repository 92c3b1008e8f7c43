"""Several processes over one mesh (``dextractor_tpu/parallel/multihost.py``).

The replacement for the reference's HPC job-array fan-out (Block_Looper,
DB.c:2657-2923): one ``torch.distributed`` group of all processes, one mesh
whose data axis spans them (parallel/mesh.py).  Nothing tells a program of
a cluster: the coordinator's address, the world size and the rank come
from the caller or from the JAX package's variables ``DXT_COORDINATOR``
(``host:port``), ``DXT_NUM_PROCESSES`` and ``DXT_PROCESS_ID``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, local_device, take_block


def init_group(coordinator: str, world: int, rank: int, backend: str):
    """``torch.distributed.init_process_group`` over TCP at ``coordinator``
    (``host:port``).  Raises when ``backend`` is not available here:
    nothing falls back to another."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return dist.group.WORLD


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> bool:
    """Join the process group, with the environment's values where an
    argument is None; does nothing for one process (the common single-host
    case).  The backend is ``nccl`` when the shards are cards (``device``
    None or CUDA) and ``gloo`` for the CPU, unless named.  Returns whether a
    group was joined."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("DXT_NUM_PROCESSES", "1"))
    if num <= 1:
        return False
    coordinator = coordinator or os.environ.get("DXT_COORDINATOR")
    if not coordinator:
        raise ValueError("several processes need a coordinator (host:port)")
    rank = process_id if process_id is not None else int(os.environ.get("DXT_PROCESS_ID", "0"))
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    init_group(coordinator, num, rank, backend)
    return True


def process_mesh(local_shards: int = 1, device=None, group=None) -> Mesh:
    """The mesh over every process of ``group`` (the default group when
    None, which must be initialised): ``local_shards`` shards a process,
    this process's on ``device`` (see mesh.local_device: None is the card
    rank modulo the cards here).  Other processes' shards are listed by the
    same rule, as each process lays out its own."""
    import torch.distributed as dist

    group = group or dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    devs = tuple(local_device(device, r) for r in range(world) for _ in range(local_shards))
    return Mesh(devs, tuple(range(rank * local_shards, (rank + 1) * local_shards)), group)


def mesh_put(mesh: Mesh):
    """An uploader for ``mesh``: put(x, axis=0, dtype=None, fill=0) ->
    [block] for this process's shards, each the shard's contiguous block of
    reads along ``axis`` (padded with zero-length reads, mesh.split) on its
    device.  Every process holds the whole host array and moves only its
    own shards' blocks."""
    def put(x, axis: int = 0, dtype=None, fill: int = 0):
        per, blocks = mesh.split(x.shape[axis])
        return [take_block(x, beg, end, per, mesh.devices[g], axis, dtype, fill)
                for g, beg, end in blocks]
    return put


def ordered_gather(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Gather variable-length per-read results back into read order.

    Shards hold contiguous read blocks in order, so the gather is a
    concatenation of (flat payload, per-read lengths) pairs (the
    reference's sequential fwrite order, dexta.c:196-204) with prefix-sum
    offsets for random access.  Returns (flat, lengths, offsets)."""
    flat = np.concatenate([p for p, _ in parts]) if parts else np.empty(0, np.uint8)
    lengths = np.concatenate([l for _, l in parts]) if parts else np.empty(0, np.int64)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return flat, lengths, offsets


def process_read_range(total_reads: int, process_id: int | None = None,
                       num_processes: int | None = None):
    """The contiguous read block [beg, end) of a process (block
    partitioning, DB.h:380-383 ublocks); this process's rank and the world
    size of the default group when not given (0 and 1 without one)."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    pid = process_id if process_id is not None else (dist.get_rank() if joined else 0)
    num = num_processes if num_processes is not None else (
        dist.get_world_size() if joined else 1)
    per = (total_reads + num - 1) // num
    beg = min(pid * per, total_reads)
    end = min(beg + per, total_reads)
    return beg, end
