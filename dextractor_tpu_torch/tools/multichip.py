"""The multi-shard run of the sharded pipeline (the port's counterpart of
``__graft_entry__.dryrun_multichip(n)``).

Dry run, one process, a mesh of ``n`` shards (parallel/mesh.make_mesh):

  A  ``sharded_scan_to_stats`` on a batch of 4n reads of 128-246 symbols,
     against the host scan (``scan_quiva``), field by field;
  B  ``sharded_qv_encode`` with the coding's run flags, against
     ``qv_encode_step`` on one device output by output, and the container
     assembled from it against the native encoder's bytes;
  C  ``decode_dexqv_to_quiva(mesh=...)`` of 4n reads of 64-2,600 symbols
     (the segmented route: reads cross 2,048 symbols) against the original;
  D  ``sharded_twobit_encode``/``_decode`` of 4n reads of 0-127 bases
     against the NumPy packer and the original letters.

    python -m dextractor_tpu_torch.tools.multichip --shards n [--device cpu]

One process of a group (``--rank``): join the group over TCP at
``--coordinator`` (``torch.distributed``, gloo for ``--device cpu`` and
NCCL for the cards unless ``--backend`` says), build the mesh of one shard
a process, run phase A over it (the histograms summed across the
processes), encode this process's block of reads
(``multihost.process_read_range``) through ``sharded_qv_encode``, frame it
as the serial encoder frames those entries (the container's header in the
part of rank 0 only) and write it to ``<out>/part<rank>.bin``.  The parts
of all ranks, concatenated in rank order, are the native encoder's file.

    python -m dextractor_tpu_torch.tools.multichip --rank r --world w \\
        --coordinator host:port --quiva f.quiva --out dir [--device cpu]

Without ``--device`` the shards are cards, and a host without CUDA raises.
Each run prints one line a phase and a last ``MULTICHIP: {...}`` JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def rect_batch(quiva: bytes):
    """(parsed .quiva, streams (5, N, L) u8, lengths (N,) i32): the reads as
    one rectangle, rows padded to a multiple of 512 symbols."""
    from ..formats.quiva import parse_quiva
    from ..formats.ragged import pad_rows

    q = parse_quiva(quiva)
    lengths = q.lengths.astype(np.int64)
    streams = np.stack([pad_rows(q.streams[s], lengths, align=512) for s in range(5)])
    return q, streams, lengths.astype(np.int32)


def stats_equal(a, b) -> bool:
    """Are two QVStats equal field by field?"""
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "del_hist", "ins_hist", "mrg_hist", "sub_hist", "del_run", "sub_run",
        "del_char", "sub_char", "tot_char"))


def step_outputs_equal(a, b) -> bool:
    """Are two sets of ``qv_encode_step`` outputs the same encode: raw,
    out, dup, zext, the packed tags and their lengths equal, the words
    equal up to each row's raw count (the kernels leave the words past it
    unwritten)?"""
    import torch

    if any(x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()) for x, y in zip(a[1:], b[1:])):
        return False
    raw = a[1].cpu().long()

    def masked(words):
        col = torch.arange(words.shape[-1])
        return torch.where(col < raw[..., None], words.cpu(), 0)

    return a[0].shape == b[0].shape and torch.equal(masked(a[0]), masked(b[0]))


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def dryrun(n_shards: int, device=None) -> dict:
    """Phases A-D on a one-process mesh of ``n_shards`` shards on ``device``
    (None: the cards).  Raises on the first disagreement; returns each
    phase's host-clock seconds and the scan's totals."""
    import torch

    from ..codecs.qv_codec import (assemble_from_step, create_qvcoding, decode_dexqv_to_quiva,
                                   encode_quiva_to_dexqv, scan_quiva, step_tables)
    from ..ops import twobit as tb
    from ..parallel import pipeline as pl
    from ..parallel.mesh import make_mesh
    from ..testing import make_quiva

    mesh = make_mesh(n_shards, device)
    n = 4 * n_shards
    res = {"shards": n_shards, "device": str(mesh.device)}

    quiva = make_quiva(np.random.default_rng(0), n_reads=n, min_len=128, max_len=246)
    q, streams, lengths = rect_batch(quiva)
    stats, res["A_s"] = _timed(pl.sharded_scan_to_stats, mesh, streams, lengths)
    if not stats_equal(stats, scan_quiva(q)):
        raise AssertionError("phase A: sharded_scan_to_stats differs from scan_quiva")
    print(f"[multichip A] scan of {n} reads over {n_shards} shards: tot {stats.tot_char}, "
          f"delChar {stats.del_char}, equal to the host scan", flush=True)

    coding = create_qvcoding(stats, q.prefix, False)
    sym, run, rchars, nlut, run_on = step_tables(coding)
    tables = (sym, run, rchars, nlut)
    out, res["B_s"] = _timed(pl.sharded_qv_encode(mesh, run_on), streams, lengths, *tables)
    single = pl.qv_encode_step(torch.from_numpy(streams).to(mesh.device),
                               torch.from_numpy(lengths).to(mesh.device), *tables,
                               run_on=run_on)
    if not step_outputs_equal(out, single):
        raise AssertionError("phase B: sharded_qv_encode differs from qv_encode_step")
    enc = assemble_from_step(out, coding, q.wells, q.begs, q.ends, q.qvs, q.n_entries)
    if enc != encode_quiva_to_dexqv(quiva, device=False):
        raise AssertionError("phase B: the assembled container differs from the native encoder's")
    print(f"[multichip B] encode: words {tuple(out[0].shape)}, run_on {run_on}, equal to "
          "qv_encode_step; container equal to the native encoder's", flush=True)

    long = make_quiva(np.random.default_rng(3), n_reads=n, min_len=64, max_len=2600)
    enc = encode_quiva_to_dexqv(long, device=False)
    dec, res["C_s"] = _timed(decode_dexqv_to_quiva, enc, mesh=mesh)
    if dec != long:
        raise AssertionError("phase C: the sharded decode differs from the original")
    print(f"[multichip C] decode of {n} reads of 64-2,600 symbols through mesh=: "
          "equal to the original", flush=True)

    rng = np.random.default_rng(5)
    dl = rng.integers(0, 128, n)
    codes = np.zeros((n, 128), np.uint8)
    for i, length in enumerate(dl):
        codes[i, :length] = rng.integers(0, 4, length)
    ascii_rows = tb.LOWER_LUT[codes]
    t0 = time.perf_counter()
    packed = pl.sharded_twobit_encode(mesh)(ascii_rows, dl, tb.NUMBER_BASE_LUT)
    letters = pl.sharded_twobit_decode(mesh)(packed, tb.LOWER_LUT)
    res["D_s"] = time.perf_counter() - t0
    packed, letters = packed.cpu().numpy(), letters.cpu().numpy()
    if not np.array_equal(packed, tb.pack_2bit_np(codes, dl)) or not all(
            np.array_equal(letters[i, :k], ascii_rows[i, :k]) for i, k in enumerate(dl)):
        raise AssertionError("phase D: the sharded 2-bit round trip differs")
    print(f"[multichip D] 2-bit pack and unpack of {n} reads: equal to the NumPy packer "
          "and the original", flush=True)
    res["tot_char"] = stats.tot_char
    res["del_char"] = stats.del_char
    return res


def rank_part(rank: int, world: int, coordinator: str, quiva_path: str, out_dir: str,
              device=None, backend: str | None = None) -> dict:
    """One process of a ``world``-process group: phase A over the global
    mesh, then this process's block of reads encoded and framed as its part
    of the container, written to ``out_dir/part<rank>.bin``."""
    import torch.distributed as dist

    from ..codecs.qv_codec import assemble_from_step, create_qvcoding, step_tables
    from ..formats.dexqv import qvcoding_bytes
    from ..parallel import multihost
    from ..parallel import pipeline as pl

    if not multihost.initialize(coordinator, world, rank, backend, device):
        raise ValueError(f"a group needs two processes or more, got {world}")
    try:
        mesh = multihost.process_mesh(1, device)
        with open(quiva_path, "rb") as f:
            q, streams, lengths = rect_batch(f.read())
        stats = pl.sharded_scan_to_stats(mesh, streams, lengths)
        coding = create_qvcoding(stats, q.prefix, False)
        sym, run, rchars, nlut, run_on = step_tables(coding)
        beg, end = multihost.process_read_range(q.n_entries)
        if mesh.split(q.n_entries)[1] != [(rank, beg, end)]:
            raise AssertionError("the mesh's block differs from process_read_range")
        out = pl.sharded_qv_encode(mesh, run_on)(streams, lengths, sym, run, rchars, nlut)
        prev = int(q.wells[beg - 1]) if beg > 0 else 0
        part = assemble_from_step(out, coding, q.wells[beg:end] - prev, q.begs[beg:end],
                                  q.ends[beg:end], q.qvs[beg:end], end - beg)
        if rank > 0:
            part = part[2 + len(qvcoding_bytes(coding)):]
        with open(os.path.join(out_dir, f"part{rank}.bin"), "wb") as f:
            f.write(part)
        backend_used = dist.get_backend()
    finally:
        dist.destroy_process_group()
    print(f"[multichip rank {rank}/{world}] reads {beg}-{end}, {len(part)} bytes, "
          f"backend {backend_used}, tot {stats.tot_char}", flush=True)
    return {"rank": rank, "world": world, "reads": [beg, end], "bytes": len(part),
            "backend": backend_used}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dextractor_tpu_torch.tools.multichip",
                                description="Run the sharded pipeline over a mesh.")
    p.add_argument("--shards", type=int, default=None, help="shards of the dry run's mesh")
    p.add_argument("--device", default=None,
                   help="the shards' device (cpu, cuda, cuda:1); default: the cards")
    p.add_argument("--rank", type=int, default=None, help="run as this rank of a group")
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--coordinator", default=None, help="host:port of rank 0")
    p.add_argument("--quiva", default=None, help="the .quiva file a rank encodes its part of")
    p.add_argument("--out", default=None, help="the directory of the parts")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    a = p.parse_args(argv)
    if a.rank is None:
        if a.shards is None:
            p.error("give --shards, or --rank with --world, --coordinator, --quiva, --out")
        res = dryrun(a.shards, a.device)
    else:
        if None in (a.world, a.coordinator, a.quiva, a.out):
            p.error("--rank needs --world, --coordinator, --quiva and --out")
        res = rank_part(a.rank, a.world, a.coordinator, a.quiva, a.out, a.device, a.backend)
    print("MULTICHIP: " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
