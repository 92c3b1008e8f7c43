"""The data mesh of the sharded pipeline (``dextractor_tpu/parallel/mesh.py``).

The only parallel axis of this domain is reads: entries are independent, so
the mesh is a 1-D ``data`` axis of shards (the reference's DB block
partitioning, DB.h:380-383).  PyTorch has no ``shard_map``; a ``Mesh`` here
is the ordered list of its shards' devices over all processes, the global
indices of this process's shards, and the ``torch.distributed`` process
group that joins the processes (None for one process).  Global shard index
= rank x local shards + local index, so shard g holds the g-th contiguous
block of reads.

A device may hold several shards: ``make_mesh(8, "cpu")`` mirrors the JAX
tests' eight virtual CPU devices, ``make_mesh(4, "cuda")`` puts four shards
on one card.  Each sharded function of ``parallel/pipeline.py`` runs its
body on every local shard in turn, on the current stream of the shard's
device.  Shards of one card therefore share one stream, and with it the
tile scratch of K1-K3 and K8 (``ops/emit.tile_scratch``, keyed by device
and stream), which is safe because launches on one stream run in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """devices: the shards' devices in global order over all processes;
    local: the global indices of this process's shards, ascending; group:
    the process group, or None for a mesh of one process."""

    devices: tuple
    local: tuple
    group: object = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of this process's first shard: where the sharded
        functions gather their results."""
        return self.devices[self.local[0]]

    @property
    def all_local(self) -> bool:
        return len(self.local) == self.size

    def split(self, n: int):
        """N reads padded with zero-length reads to a multiple of the shard
        count, in equal contiguous blocks: (per, [(shard, beg, end)] for
        this process's shards), [beg, end) the shard's real reads (end - beg
        may fall short of per, down to 0, in the last blocks)."""
        per = -(-n // self.size)
        return per, [(g, min(g * per, n), min((g + 1) * per, n)) for g in self.local]

    def agrees(self, device: torch.device) -> bool:
        """Is ``device`` (a torch.device) where this process's shards are?
        A device without an index agrees with every device of its type."""
        return all(d.type == device.type and (device.index is None or d.index == device.index)
                   for d in (self.devices[g] for g in self.local))


def _cuda(index=None) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested but torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device() if index is None else index)


def local_device(device=None, rank: int = 0) -> torch.device:
    """A shard's device: ``device`` as given ("cpu", "cuda", "cuda:1", a
    torch.device; "cuda" without an index is the current card), or, for
    None, the card ``rank`` modulo the cards present (raises without CUDA:
    nothing falls back to the CPU)."""
    if device is None:
        return _cuda(rank % max(torch.cuda.device_count(), 1))
    d = torch.device(device)
    return _cuda(d.index) if d.type == "cuda" else d


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of one process.  device None: one shard a visible card, or
    ``n_shards`` over the cards in turn; a device given: every shard on it.
    Raises when CUDA is asked for (explicitly or by None) and absent."""
    if device is None:
        devs = [_cuda(i) for i in range(torch.cuda.device_count())] or [_cuda()]
    else:
        devs = [local_device(device)]
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)), tuple(range(n)))


def check_device(mesh: Mesh, device) -> torch.device:
    """The device a decode entry point runs on when given ``mesh``: the
    mesh's.  ``device`` (a resolved torch.device, or None) must agree with
    it, and every shard must belong to this process; raises otherwise."""
    if device is not None and not mesh.agrees(torch.device(device)):
        raise ValueError(f"device {device} disagrees with the mesh's shards on "
                         f"{sorted({str(mesh.devices[g]) for g in mesh.local})}")
    if not mesh.all_local:
        raise ValueError("this entry point takes a mesh of one process "
                         f"({len(mesh.local)} of {mesh.size} shards are local)")
    return mesh.device


def take_block(x, beg: int, end: int, per: int, device, axis: int = 0, dtype=None,
               fill: int = 0) -> torch.Tensor:
    """Rows [beg, end) of ``x`` (numpy or tensor) along ``axis``, padded with
    ``fill`` to ``per`` rows, as a contiguous tensor on ``device``.  u32
    numpy words travel as int32 bit patterns."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    else:
        x = torch.as_tensor(x)
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(beg, end)
    b = x[tuple(idx)].to(device=device, dtype=dtype)
    if end - beg < per:
        shape = list(b.shape)
        shape[axis] = per - (end - beg)
        b = torch.cat([b, torch.full(shape, fill, dtype=b.dtype, device=b.device)], axis)
    return b.contiguous()


_OPS = ("sum", "min", "max")


def all_reduce(mesh: Mesh, parts, op: str) -> torch.Tensor:
    """Reduce one small tensor a local shard over the mesh with ``op``
    ("sum", "min" or "max": JAX's psum, pmin, pmax): first over the local
    shards on ``mesh.device``, then ``dist.all_reduce`` over the group when
    there is one, the tensor on the card for NCCL and on the host for gloo.
    Returns the result on ``mesh.device``."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    x = torch.stack([p.to(mesh.device) for p in parts])
    x = {"sum": x.sum, "min": x.amin, "max": x.amax}[op](0)
    if mesh.group is None:
        return x
    import torch.distributed as dist

    home = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    y = x.to(home, copy=True)
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}[op], group=mesh.group)
    return y.to(mesh.device)
