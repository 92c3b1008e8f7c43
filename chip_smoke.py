#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the .dexqv encode and
decode paths, the 2-bit codecs (.dexta, .dexar), the decode step's
phase split (tools/decode_ablate.py), dextract, dex2DB and the Dazzler
DB's QV load, the sharded pipeline, the v1 stream decoders and the 2-bit
device ops, and the encode step's tools (step_verify, encode_split).

Run from the repository root on a machine with an sm_90 card:

    python3 chip_smoke.py [--out FILE]

Phases, each printing one line (or a few) before the final JSON lines:

1. environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and nvcc versions, the card's copy bandwidth (1 GiB ``copy_``); the
   card must have compute capability (9, 0);
2. build: compile ops/csrc/*.cu with nvcc for sm_90a, one compiler per
   source, all at once, and the native C shims with gcc, timed; each
   kernel's registers, shared memory and spills (ptxas);
3. encode kernels: K1 (encode_plain), K2 (encode_run) and K3 (pack_tags) on
   the card against their plain PyTorch twins, bit for bit, at the shapes of
   the 16 MB uniform batch and on rows of up to 70,000 symbols; K1 also on
   testing.encode_edge_rows (rows of 0, 1, 31, 32, 33 symbols and over
   several tiles, all escapes, 0-bit codes only, a width no multiple of 16),
   K2 and K3 on testing.run_edge_rows (rows of 0-33 symbols, no literal,
   literals only at the ends, runs of 255 and 256 and across tiles, runs
   of 65,535 and 65,536 and trailing runs over 65,535 in 70,000-symbol
   rows, a width no multiple of 4; K3 with delChar and with -1); K1 and K2
   timed at the widest bucket of the long-read batch that K1/K2 take, K3 at
   the widest bucket of the long-read batch; K9
   (lut_gather, every lookup of a bucket in one launch) and K8 (pack_words)
   on what the encode step's emission route gives them at the widest
   bucket of the long-read batch (five lookups of 8 x 61,440, 122,881
   slots on its one RLE channel) and on edge inputs (K9: groups of 0 and of one
   element, views one element into their buffers, u8 and int32 in one
   launch, nine groups in two launches, every u8 and run index 0-255; K8: 0
   slots, all-zero widths, 32-bit emissions that straddle words; both:
   type-2 and run escapes from 70,000-symbol rows); K9 also timed on one
   lookup beside torch.take, K8 at the narrowest bucket the emission route
   takes;
4. encode slice: encode_quiva_to_dexqv(device=True) on four corpora (the
   uniform batch, a sub-heavy corpus, the same lossy, the log-normal
   long-read batch), each byte for byte against the native C encoder
   (device=False); every bucket takes the route that emit.fused_ok gives
   its width (the uniform batch K1-K3 only); every encode kernel launched
   in this phase, no twin;
5. encode step: median stream time of qv_encode_step on the uniform batch,
   and the share of it the card was busy; the stream time of the widest
   long-read bucket's four QV channels through each route (K1/K2, K9/K8);
   the device time of each encode kernel over one encode of the long-read
   batch, its launches and their mean; K9 must launch once per emission
   bucket (23);
6. decode kernels: K4 (decode_plain: ins, mrg, sub in one launch, and one
   channel), K5 (decode_run) on delQV and K6 (expand_runs) with the delTag
   codes on delQV at the uniform batch's decode shapes, K5 and K6 on subQV
   of the sub-heavy corpus, and the edge rows of
   testing.decode_edge_cases (among them run chains whose every code is 8
   bits long, and whose every code is an escape; each run chain also cut
   at a third of its tokens), K6 also on testing.expand_edge_cases (rows
   wider than a window with and without tags, tag bytes that stop short of
   the tokens, literals past max_len, a max_len no multiple of 16, odd
   token counts, sparse rows over many windows, 70,000-symbol rows) and on
   tools/decode_ablate.py's random tokens, each against its twin bit for
   bit;
7. decode slice: decode_dexqv_to_quiva(device=True) on the four encoded
   corpora against the original .quiva and the native walker
   (device=False), through the segmented route (the default: every corpus
   has reads over 2,048 symbols) and through the per-read route
   (DXT_SEG_DECODE=0); every decode kernel launched on each, no twin;
8. decode step: median stream time and busy share of decode_entry_batch2
   on the uniform batch as one rectangle; then the device time of each
   decode kernel over one decode of the long-read batch on each route.
9. 2-bit kernels: K7 (pack2bit) and the unpack (unpack2bit) against their
   twins, bit for bit, on the flat reads of the three 2-bit corpora of
   phase 10, on edge reads (lengths 0-7, a 70,000-base read, every byte
   value) and on testing.twobit_tile_edges (K7's payload tiles: thousands
   of empty reads in a tile, reads ending at tile boundaries, a read over
   two tiles, a first base off 16-byte alignment) with the base, arrow and
   a random table and the three letter tables, the unpack also on
   testing.twobit_letter_tile_edges (its letter tiles: the same kinds of
   reads, reads of one letter whose tile's payload is a byte a letter, a
   payload 1-15 bytes into its buffer) with the three letter tables; both
   timed at the three corpora's shapes;
10. 2-bit slice: encode_fasta_to_dexta / encode_arrow_to_dexar and their
   decoders with device=True on three corpora (the uniform .fasta, a
   log-normal long-read .fasta, an .arrow of 8,000 reads), each encode byte
   for byte against the native host path (device=False), each decode
   against the original text and the native path; both 2-bit kernels
   launched in this phase, no twin;
11. tag kernel: K10 (tag_route) against its twin, bit for bit, on the
   uniform batch's tag rectangle with the state built from that batch's
   decoded delQV rows (and against the TAG rows of that decode), and on the
   edge inputs of testing.tag_edge_cases (reads of length 0, all kept and
   none kept, a 70,000-symbol row of 4,375 tag words, kept ranks past the
   row's words, widths that are no multiple of 128, an unaligned state);
12. decode phase split: the port's tools/decode_ablate.py at --mb 16 in
   process (the fused step, the delQV run chains, one plain channel, the
   run expansion, and the delTag prep with K10), its ABLATE line; its tag
   phase launched K10 and no twin ran;
13. Dazzler DB: whether libhdf5 loads; BAMs of the uniform batch (1,600
   reads of 1,950-2,050, seed 0) and of the log-normal long-read batch
   (seed 2) written by testing.make_bam; dextract -f -q -a and dex2DB -q on
   each, and a DB of both (two cells, two codings); DazzDB.load_all_qventries
   on the card through the fused route with the qvchk track (ascii modes 0,
   1 and 2 on the two-cell DB), the fused route after the track is deleted
   (the native lens walk) and the per-scheme route (DXT_DB_FUSED=0, modes
   0, 1 and 2), each against the streams of the .quiva files dextract
   wrote and, once a DB and route, against the host per-read load_qventry
   on every 25th read, with its host-clock seconds and stages beside those
   of the per-read loader; the fused route launched K4 on three channels at once, K5 and
   K6, the per-scheme route K4 on one channel at a time, K5 and K6, and no
   twin ran;
14. sharded pipeline (parallel/), reusing the corpora above: meshes of 1, 2
   and 4 shards on cuda:0, each against its one-device or native
   counterpart: sharded_scan_to_stats against scan_quiva on the uniform
   and long-read .quiva; sharded_qv_encode against qv_encode_step on the
   uniform rectangle (K1/K2, and its container against the native
   encoder's) and the widest long-read bucket (K9/K8);
   decode_dexqv_to_quiva(mesh=) of both .dexqv through the segmented and
   the per-read route against the original; load_all_qventries(mesh=) of
   the two-cell DB against the load without a mesh (one shard) on the
   fused (lens walk) and the per-scheme route;
   sharded_twobit_encode/decode of the uniform .fasta rows against one
   shard; each with its host-clock seconds a shard count and a check that
   its kernels, and no twin, ran; then a one-rank NCCL group (the scan and
   one decode through its collectives) and two processes of
   tools/multichip.py over gloo sharing the card, whose parts concatenated
   must be the native encoder's file; the phase's wall seconds, and each
   check's end after the phase's start.  Several shards on one card
   measure the cost of sharding, not scaling.
15. v1 decoders and the surface: ops/decode_torch.decode_plain_batch on
   insQV and decode_run_batch on delQV of the uniform and the long-read
   .dexqv (each stream's start from the index walk), K4b and K5 launched
   and no twin, each against the per-scheme route's rows
   (batch_decode_entries) and the walk's stream lengths, the uniform one
   also against the twins on the card, and sharded_decode_plain/_run on 1,
   2 and 4 shards against one device; the 2-bit device ops of
   ops/twobit.py (pack_translate, translate, pack_2bit, unpack_translate,
   unpack_2bit) on the uniform .fasta rows, K7, K9 and the unpack launched
   and no twin, each against its twin; tools/step_verify (its STEPV line:
   the uniform encode step's container equals the native encoder's) and
   tools/encode_split (its SPLIT line: each sub-call of the encode step
   timed alone, and the glue), in process.

Each kernel is timed, at the main path's shapes, as device time per call
from a torch.profiler trace (``ms``, with L2 flushed before each launch, as
the main path finds it; ``warm_ms`` with the inputs left in L2 by the
launch before), stream time from CUDA events (``event_ms``, warm), and
beside its twin's device time (``plain_ms``) and, where one PyTorch call
computes the same function, that call's device time with warm L2
(``library_ms``); ``bound_ms`` is the bytes the function must move over
the card's published memory rate; ``ops_per_call`` the device operations
per call in a warm trace of 20 calls (1: the call is its one kernel, so
``ms`` is its device time; below 1 where the trace dropped operations; a
call of more than one fails).  It prints the
kernels as one JSON line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the exit code is non-zero and no result is printed.
It exits 1 at once when torch.cuda.is_available() is False.  With
``--out FILE`` it also writes a JSON record of the run: the UTC time, the
checkout's ``git rev-parse HEAD`` (null outside a checkout), the card's
name and power limit, each phase's name, ok and wall seconds, and the
kernels line (``RunRecord``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

EMIT = "dextractor_tpu_torch/ops/csrc/emit.cu"
DECODE = "dextractor_tpu_torch/ops/csrc/decode.cu"
TWOBIT = "dextractor_tpu_torch/ops/csrc/twobit.cu"
TAG = "dextractor_tpu_torch/ops/csrc/tag.cu"
KERNELS = {   # wrapper name -> (source, the TPU kernel it replaces)
    "encode_plain": (EMIT, "dextractor_tpu/ops/emit_pallas.py:623"),
    "encode_run": (EMIT, "dextractor_tpu/ops/emit_pallas.py:662"),
    "pack_tags": (EMIT, "dextractor_tpu/ops/emit_pallas.py:551"),
    "lut_gather": (EMIT, "dextractor_tpu/ops/lut_pallas.py:56 (K9), "
                         "dextractor_tpu/ops/lut_pallas.py:87 (K9b)"),
    "pack_words": (EMIT, "dextractor_tpu/ops/pack_pallas.py:99"),
    "decode_plain": (DECODE, "dextractor_tpu/ops/decode_conveyor.py:612 (K4a), "
                             "dextractor_tpu/ops/decode_conveyor.py:986 (K4b)"),
    "decode_run": (DECODE, "dextractor_tpu/ops/decode_conveyor.py:1059"),
    "expand_runs": (DECODE, "dextractor_tpu/ops/expand_pallas.py:53"),
    "pack2bit": (TWOBIT, "dextractor_tpu/ops/emit_pallas.py:516"),
    "unpack2bit": (TWOBIT, "none (no pallas_call): the JAX package's unpack is "
                           "dextractor_tpu/ops/twobit.py:157 unpack_translate, XLA"),
    "tag_route": (TAG, "dextractor_tpu/ops/tag_pallas.py:67"),
}
ENCODE_KERNELS = ("encode_plain", "encode_run", "pack_tags", "lut_gather", "pack_words")
DECODE_KERNELS = ("decode_plain", "decode_run", "expand_runs")
TWOBIT_KERNELS = ("pack2bit", "unpack2bit")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published (NVIDIA data sheet)
COPY_BW = {}                 # the card's measured copy bandwidth, phase 1


def log(msg: str) -> None:
    print(msg, flush=True)


def on_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def cuda_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Median over ``rounds`` of the stream time per call of fn(), in ms,
    from CUDA events around ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, match: str | None = None, warm: bool = True):
    """Device time per call of fn() in ms: the summed durations of the
    kernels and copies it ran on the card, from a torch.profiler (CUPTI)
    trace of ``reps`` calls, and the number of those device operations per
    call.  With ``match``, fn() launches one kernel whose name contains
    ``match``, and the time is the mean duration of its launches in the
    trace.  Unlike cuda_ms it excludes the gaps in which the card waited
    for the host.

    A trace of a twin's call holds up to ~215,000 device operations, near
    what the profiler's activity buffers take, and the traces after such a
    one can come back with no device activity, or (with ``match``) with
    fewer than ``reps`` of the kernel's launches, several in a row; such a
    trace is taken again, up to eight times in all, and said so.  If none
    holds them all, the mean of the kernel's launches in the trace that
    holds the most is the time; None when none holds any of the
    operations sought."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    best = None   # (mean, launches) of the fullest partial trace, with ``match``
    for attempt in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and (match is None or match in e.name)]
        total = sum(e.time_range.elapsed_us() for e in ev) / 1000
        if ev and (match is None or len(ev) >= reps):
            return total / (len(ev) if match else reps), len(ev) / reps
        if ev and match and (best is None or len(ev) > best[1]):
            best = (total / len(ev), len(ev))
        if attempt == 7:
            break
        log(f"[profiler] a trace of {reps} call(s) came back with {len(ev)} of the "
            f"device operations sought; tracing again")
    return (best[0], best[1] / reps) if best else (None, 0)


def phase_environment():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from dextractor_tpu_torch.ops._build import nvcc_path

    ver = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    m = re.search(r"release ([0-9.]+)", ver)
    cap = torch.cuda.get_device_capability(0)
    card = smi.splitlines()[0]
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc {m.group(1) if m else '?'} capability {cap} "
        f"devices {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels need (9, 0)")
    a = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(lambda: b.copy_(a), reps=10, rounds=3, warmup=2)
    COPY_BW["bytes_per_s"] = 2 * a.numel() / (ms / 1e3)
    del a, b
    log(f"[env] copy bandwidth {COPY_BW['bytes_per_s'] / 1e12} TB/s "
        f"(1 GiB copy_, read + write, {ms} ms)")
    return card


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name inside a mangled symbol: the shortest name that a
    run of digits gives the length of (an anonymous namespace adds a prefix
    that may end in digits too, and a length of its own that spans it)."""
    names = []
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            n = int(digits[i:])
            name = mangled[m.end():m.end() + n]
            if (len(name) == n and name.endswith("_kernel")
                    and re.fullmatch(r"[A-Za-z_]\w*", name)):
                names.append(name)
    return min(names, key=len) if names else mangled


def ptxas_summary(out: str):
    """[(kernel, "Used N registers, ... smem; F bytes stack frame, S bytes
    spill stores, L bytes spill loads")] from ``nvcc -Xptxas -v`` output,
    one entry per compiled kernel (a template kernel once per instance), in
    the order compiled."""
    res, name, spills = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), ""
        elif "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line:
            used = line.split(":", 1)[1].strip()
            res.append((name, f"{used}; {spills}"))
            name = None
    return res


def phase_build():
    from dextractor_tpu_torch.ops import _build
    from dextractor_tpu_torch.utils import dispatch

    _, seconds, out = _build.build(force=True)
    dispatch.kernels()
    for name, props in ptxas_summary(out):
        log(f"[ptxas] {name}: {props}")
    log(f"[build] nvcc sm_90a, {len(_build.sources())} sources at once, {seconds:.2f} s")
    # the native shims build with gcc at first use: here, so that no
    # phase's host-clock stages count a compiler
    from dextractor_tpu_torch import native

    t0 = time.perf_counter()
    for shim in (native.qv_encode_shim, native.qv_decode_shim,
                 native.twobit_host_shim, native.dexta_index_shim):
        shim()
    log(f"[build] native shims (gcc, where not built yet) {time.perf_counter() - t0:.2f} s")


def _masked(x, lim):
    """x (..., W) with columns >= lim[...] zeroed, as int64."""
    import torch

    col = torch.arange(x.shape[-1], device=x.device)
    return torch.where(col < lim[..., None].long(), x.long(), 0)


def _max_err(pairs):
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def _check_words(name, got, ref):
    """(words, t, lg) of kernel and twin: t, lg and the words up to
    ceil(t/32) must be bit-identical."""
    wk, tk, lgk = got
    wt, tt, lgt = ref
    raw = (tt.long() + 31) >> 5
    pairs = [(tk, tt), (lgk, lgt), (_masked(wk, raw), _masked(wt, raw))]
    err = _max_err(pairs)
    if err or wk.shape != wt.shape:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max abs err {err}, shapes {wk.shape} {wt.shape})")
    return err


def _check_tags(got, ref):
    (pk, ck), (pt, ct) = got, ref
    nb = (ct.long() + 3) >> 2
    err = _max_err([(ck, ct), (_masked(pk, nb), _masked(pt, nb))])
    tail = int((pk.long() - _masked(pk, nb)).abs().max()) if pk.numel() else 0
    if err or tail:
        raise AssertionError(f"pack_tags: kernel disagrees with its twin "
                             f"(max abs err {err}, nonzero tail {tail})")
    return err


def _check_same(name, got, ref):
    """Every output of kernel and twin equal: shapes, dtypes, values."""
    got = [g for g in got if g is not None]
    ref = [r for r in ref if r is not None]
    if len(got) != len(ref) or any(g.shape != r.shape or g.dtype != r.dtype
                                   for g, r in zip(got, ref)):
        raise AssertionError(f"{name}: kernel and twin outputs differ in shape or type")
    err = _max_err(list(zip(got, ref)))
    if err:
        raise AssertionError(f"{name}: kernel disagrees with its twin (max abs err {err})")
    return err


def _words_out(t):
    """Bytes of the words up to ceil(t/32) of every row: what an encode
    writes, or a decode chain of t bits reads."""
    return 4 * int(((t.long() + 31) >> 5).sum())


def measure(name, kern, twin, nbytes, slow_twin=False, library=None, label=None):
    """Times of kernel ``kern`` and twin ``twin`` (argument-free calls) on
    the card; ``nbytes`` the bytes the function must move."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    match = f"{name}_kernel"
    event_ms = cuda_ms(kern)
    warm_ms, _ = device_ms(kern, match=match)
    ms, _ = device_ms(lambda: (flush.zero_(), kern()), match=match)
    # the device operations of one call (warm): where it is one, the
    # kernel's mean time per launch (ms, warm_ms) is the call's device time;
    # a call of more than one (a memset, a copy beside the kernel) fails
    # (below one: the trace dropped operations)
    _, ops = device_ms(kern)
    if ops > 1:
        raise AssertionError(f"{label or name}: {ops} device operations per call, "
                             "expected its one kernel")
    if slow_twin:
        plain_event_ms = cuda_ms(twin, reps=1, rounds=1, warmup=0)
        plain_ms, n_ops = device_ms(twin, reps=1, warm=False)
    else:
        plain_event_ms = cuda_ms(twin, reps=3, warmup=1)
        plain_ms, n_ops = device_ms(twin, reps=3)
    library_ms = device_ms(library)[0] if library else None
    empty = [k for k, v in (("ms", ms), ("warm_ms", warm_ms), ("plain_ms", plain_ms),
                            ("library_ms", library_ms if library else 0)) if v is None]
    if empty:
        raise RuntimeError(f"{name}: the profiler recorded no device time for {empty}")
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_copy_ms = nbytes / COPY_BW["bytes_per_s"] * 1e3
    log(f"[kernel] {label or name}: device time (profiler) kernel {ms} ms L2 flushed, "
        f"{warm_ms} ms warm; twin {plain_ms} ms in {n_ops} device ops; stream time "
        f"(CUDA events) kernel {event_ms} ms, twin {plain_event_ms} ms; "
        f"{nbytes} bytes: bound {bound_ms} ms at {PEAK_BYTES_PER_S / 1e12} TB/s, "
        f"{bound_copy_ms} ms at the copy bandwidth; {ops} device ops per call"
        + (f"; library call {library_ms} ms warm" if library else ""))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "event_ms": event_ms,
            "plain_event_ms": plain_event_ms, "warm_ms": warm_ms, "bytes": nbytes,
            "bound_copy_ms": bound_copy_ms, "ops_per_call": ops}


def wide_rows(rchar: int, l: int = 70_000, seed: int = 11):
    """Rows of up to ``l`` symbols (at the default: one all-rchar row, a
    trailing run over 65,535), sparse literals (runs over 255), a run of
    66,000 before a literal, dense random rows, an empty row and a
    one-symbol row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 8
    d = np.full((n, l), rchar, np.uint8)
    d[1, ::300] = 40
    d[2] = rng.integers(33, 63, l)
    d[3, min(66_000, l - 1)] = 41
    d[4] = np.where(rng.random(l) < 0.3, rng.integers(33, 63, l), rchar)
    d[5] = rng.integers(0, 256, l)
    d[7] = np.where(rng.random(l) < 0.01, rng.integers(33, 63, l), rchar)
    lengths = np.array([l, l, l * 6 // 7, l, l, min(12_345, l), 1, 0], np.int32)
    tags = rng.choice(np.frombuffer(b"acgtn", np.uint8), size=(n, l))
    return d, lengths, tags


def concentrated_luts():
    """A skewed scheme with escapes (type 2) as a packed LUT."""
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.testing import edge_schemes

    scheme = edge_schemes()["type2"][0]
    if scheme.type != 2:
        raise AssertionError("the concentrated scheme has no escapes")
    return bt.scheme_luts(scheme)


def route_inputs(fn):
    """The arguments that fn() gives the wrappers of K9 (lut_gather_groups)
    and K8 (pack_words), recorded while the twins stand in for the wrappers
    (no kernel launches): {"lut_gather": [(groups, luts)], "pack_words":
    [(v, n)]}."""
    from dextractor_tpu_torch.ops import lut

    seen = {"lut_gather": [], "pack_words": []}
    saved = lut.lut_gather_groups, lut.pack_words

    def recorder(name, twin):
        def call(*args):
            seen[name].append(args)
            return twin(*args)
        return call

    lut.lut_gather_groups = recorder("lut_gather", lut.lut_gather_groups_ref)
    lut.pack_words = recorder("pack_words", lut.pack_words_ref)
    try:
        fn()
    finally:
        lut.lut_gather_groups, lut.pack_words = saved
    return seen


def _groups_bytes(groups, luts):
    """Bytes that K9 must move for ``groups``: each element read once and
    its entry written once, each table used read once."""
    used = {int(k) for data, k in groups if data.numel()}
    return sum(d.numel() * (d.element_size() + 4) for d, _ in groups) + 1024 * len(used)


def emission_edges(dev, wide_len: int):
    """Edge inputs of K9 and K8 on ``dev``.  K9, as (groups, luts): every u8
    and every run index 0-255 as int32, also as views one element into
    their buffers (too unaligned for K9's vector loads), each alone; groups
    of 0 and of one element among u8 and int32 groups of whole and partial
    tiles in one launch; nine groups (two launches).  K8, as (v, n): 0
    slots, all-zero widths, and 32-bit emissions of which all but the first
    straddle words."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    luts = torch.from_numpy(rng.integers(0, 1 << 30, (8, 256)).astype(np.int32)).to(dev)
    idx = torch.arange(257, dtype=torch.int32, device=dev) % 256
    single = [idx[:256].to(torch.uint8), idx[:256].reshape(16, 16),
              idx.to(torch.uint8)[1:], idx[1:]]
    tiles = torch.from_numpy(rng.integers(0, 256, 3 * 4096 + 5, dtype=np.int32)).to(dev)
    mixed = [(tiles.to(torch.uint8), 0), (torch.zeros(0, dtype=torch.uint8, device=dev), 1),
             (tiles[1:4098], 2), (idx[255:256], 3), (tiles[:8192].reshape(2, 4096), 4),
             (tiles.to(torch.uint8)[3:4100], 5), (torch.zeros(0, dtype=torch.int32, device=dev), 6),
             (idx.to(torch.uint8)[:1], 7)]
    lut_in = [([(x, k)], luts) for k, x in enumerate(single)]
    lut_in += [(mixed, luts), (mixed + [(tiles, 7)], luts)]
    wide = np.full((3, wide_len), 32, np.int32)
    wide[:, 0] = 3
    v = rng.integers(0, 1 << 32, wide.shape, dtype=np.uint64)
    v[:, 0] &= 7
    pack_in = [(torch.zeros((3, 0), dtype=torch.int32, device=dev),) * 2,
               (torch.zeros((4, 1000), dtype=torch.int32, device=dev),) * 2,
               (torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(dev),
                torch.from_numpy(wide).to(dev))]
    return lut_in, pack_in


def narrowest_pack_words(long: bytes, dev):
    """K8's widest input (the RLE plane) at the narrowest bucket of
    ``long`` that the emission route takes (``emit.fused_ok`` refuses its
    width), recorded as in ``route_inputs``, and a label."""
    import torch
    from dextractor_tpu_torch.codecs.qv_codec import encode_buckets
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.ops.emit import fused_ok
    from dextractor_tpu_torch.parallel import pipeline
    from dextractor_tpu_torch.testing import widest_bucket_batch

    widths = [w for w, _ in encode_buckets(parse_quiva(long).lengths)]
    i = next(i for i, w in enumerate(widths) if not fused_ok(w))
    (streams, lengths, sym, run, rchars, _), run_on = widest_bucket_batch(long, i)
    step_in = [torch.from_numpy(a).to(dev) for a in (streams, lengths, sym, run, rchars)]
    seen = route_inputs(lambda: pipeline.channels_emissions(*step_in, run_on))
    pw = max(seen["pack_words"], key=lambda a: a[0].shape[1])
    return pw, (f"pack_words (narrowest emission-route bucket, width {widths[i]}, "
                f"{pw[0].shape[0]} x {pw[0].shape[1]} slots)")


def widest_fused_plain(long: bytes, dev):
    """K1's input at the widest bucket of ``long`` that the encode step
    sends through K1/K2 (``emit.fused_ok``): (data, lengths, luts) of its
    plain QV channels on ``dev``, and a label."""
    import torch
    from dextractor_tpu_torch.testing import plain_rows, widest_bucket_batch, widest_fused_bucket

    i, width = widest_fused_bucket(long)
    args = tuple(torch.from_numpy(a).to(dev) for a in plain_rows(widest_bucket_batch(long, i)))
    return args, (f"encode_plain (widest K1 bucket of the long-read batch, width {width}, "
                  f"{tuple(args[0].shape)})")


def widest_fused_run(long: bytes, dev):
    """K2's input at the widest bucket of ``long`` that the encode step
    sends through K1/K2: (data, lengths, LUTs, run LUTs, rchars) of its RLE
    QV channels on ``dev``, and a label."""
    import torch
    from dextractor_tpu_torch.testing import run_rows, widest_bucket_batch, widest_fused_bucket

    i, width = widest_fused_bucket(long)
    args = tuple(torch.from_numpy(a).to(dev) for a in run_rows(widest_bucket_batch(long, i)))
    if not args[0].shape[0]:
        raise AssertionError("the long-read batch has no RLE channel")
    return args, (f"encode_run (widest K2 bucket of the long-read batch, width {width}, "
                  f"{tuple(args[0].shape)})")


def widest_tags(long: bytes, dev):
    """K3's input at the widest bucket of ``long``, as qv_encode_step gives
    it (tags, delQV, lengths, delChar, number LUT) on ``dev``, and a label."""
    import torch
    from dextractor_tpu_torch.testing import widest_bucket_batch

    (streams, lengths, _, _, rchars, nlut), _ = widest_bucket_batch(long)
    s = torch.from_numpy(streams).to(dev)
    args = (s[1], s[0], torch.from_numpy(lengths).to(dev),
            torch.from_numpy(rchars[0:1].copy()).to(dev), torch.from_numpy(nlut).to(dev))
    return args, (f"pack_tags (widest bucket of the long-read batch, width {streams.shape[2]}, "
                  f"{tuple(args[0].shape)})")


def phase_encode_kernels(device, uniform: bytes, long: bytes, wide_len: int = 70_000):
    """K1-K3 against their twins on ``device``, at the uniform batch's
    shapes and on ``wide_rows(wide_len)``, K1 also on ``encode_edge_rows``
    and K2 and K3 on ``run_edge_rows`` (with rows of ``wide_len`` symbols
    when it is at least 66,000); K9 and K8 on the inputs that the
    emission route gives them at the widest bucket of ``long`` and on edge
    rows (``wide_rows``' emissions, ``emission_edges``); on the card also
    their times (see ``measure``).  Returns {kernel: {max_abs_err, times...}}."""
    import torch
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.parallel.pipeline import _pack_tags
    from dextractor_tpu_torch.testing import encode_edge_rows, run_edge_rows, step_batch

    (streams, lengths, sym, run, rchars, nlut), run_on = step_batch(uniform)
    dev = torch.device(device)
    s = torch.from_numpy(streams).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    sym_d = torch.from_numpy(sym).to(dev)
    run_d = torch.from_numpy(run).to(dev)
    rch = torch.from_numpy(rchars).to(dev)
    nl = torch.from_numpy(nlut).to(dev)
    plane = (0, 2, 3, 4)
    run_cs = [c for c, on in ((0, run_on[0]), (3, run_on[1])) if on]
    plain_cs = [c for c in range(4) if c not in run_cs]
    if not run_cs:
        raise AssertionError("the uniform batch has no RLE channel")
    p_in = (torch.stack([s[plane[c]] for c in plain_cs]), ln,
            sym_d[plain_cs].contiguous())
    r_in = (torch.stack([s[plane[c]] for c in run_cs]), ln,
            sym_d[run_cs].contiguous(), run_d[run_cs].contiguous(),
            rch[run_cs].contiguous())
    t_in = (s[1], s[0], ln, rch[0:1].contiguous(), nl)
    n_sym = int(lengths.sum())
    n = len(lengths)
    cases = {   # kernel, twin, inputs, check, bytes moved (inputs, outputs)
        "encode_plain": (emit.encode_plain, bt.encode_plain_ref, p_in, _check_words,
                         lambda out: len(plain_cs) * (n_sym + 1024 + 8 * n) + 4 * n
                         + _words_out(out[1])),
        "encode_run": (emit.encode_run, bt.encode_run_ref, r_in, _check_words,
                       lambda out: len(run_cs) * (n_sym + 2052 + 8 * n) + 4 * n
                       + _words_out(out[1])),
        "pack_tags": (emit.pack_tags, _pack_tags, t_in,
                      lambda _n, g, r: _check_tags(g, r),
                      lambda out: 2 * n_sym + 8 * n + 260 + out[0].numel()),
    }
    res = {}
    shape = tuple(streams.shape)
    for name, (kern, twin, args, check, nbytes) in cases.items():
        out = kern(*args)
        err = check(name, out, twin(*args))
        res[name] = {"max_abs_err": err}
        if on_card(dev):
            res[name].update(measure(name, lambda: kern(*args), lambda: twin(*args),
                                     nbytes(out)))
        log(f"[kernel] {name} streams {shape} bit-identical to twin")

    d, wl, tags = wide_rows(int(rchars[0]) if rchars[0] >= 0 else 102, wide_len)
    dd = torch.from_numpy(d).to(dev)
    wld = torch.from_numpy(wl).to(dev)
    conc = torch.from_numpy(concentrated_luts()).to(dev)[None]
    p_w = (dd[None], wld, conc)
    r_w = (dd[None], wld, sym_d[0:1].contiguous(), run_d[0:1].contiguous(),
           rch[0:1].contiguous())
    t_w = (torch.from_numpy(tags).to(dev), dd, wld, rch[0:1].contiguous(), nl)
    for name, args in (("encode_plain", p_w), ("encode_run", r_w),
                       ("pack_tags", t_w)):
        kern, twin, _, check, _ = cases[name]
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       check(name, kern(*args), twin(*args)))
    runs = "runs > 255 and > 65,535" if wide_len > 65_535 else "runs > 255"
    log(f"[kernel] wide rows {tuple(d.shape)} ({runs}, type-2 escapes): K1, K2, K3 "
        "bit-identical to their twins")
    for label, data, lens, luts in encode_edge_rows(min(9000, wide_len)):
        args = tuple(torch.from_numpy(a).to(dev) for a in (data, lens, luts))
        res["encode_plain"]["max_abs_err"] = max(
            res["encode_plain"]["max_abs_err"],
            _check_words("encode_plain", emit.encode_plain(*args), bt.encode_plain_ref(*args)))
        log(f"[kernel] encode_plain edge rows ({label}, {tuple(data.shape)}) bit-identical "
            "to twin")
    long_len = wide_len if wide_len >= 66_000 else 0
    for label, data, lens, sl, rl, rc, tags in run_edge_rows(min(9000, wide_len), long_len):
        a = tuple(torch.from_numpy(x).to(dev) for x in (data, lens, sl, rl, rc))
        res["encode_run"]["max_abs_err"] = max(
            res["encode_run"]["max_abs_err"],
            _check_words("encode_run", emit.encode_run(*a), bt.encode_run_ref(*a)))
        for dc in (int(rc[0]), -1):
            t_a = (torch.from_numpy(tags).to(dev), a[0][0], a[1],
                   torch.tensor([dc], dtype=torch.int32, device=dev), nl)
            res["pack_tags"]["max_abs_err"] = max(
                res["pack_tags"]["max_abs_err"], _check_tags(emit.pack_tags(*t_a), _pack_tags(*t_a)))
        log(f"[kernel] encode_run and pack_tags (delChar {int(rc[0])} and -1) edge rows "
            f"({label}, {tuple(data.shape)}) bit-identical to their twins")
    if on_card(dev):
        # K1 and K2 at the widest bucket of the long-read batch that takes
        # K1/K2, K3 at the widest bucket of the long-read batch
        wide = {}
        args, label = widest_fused_plain(long, dev)
        out = emit.encode_plain(*args)
        _check_words(label, out, bt.encode_plain_ref(*args))
        c, n, width = args[0].shape
        n_sym = int(args[1].long().clamp(max=width).sum())
        wide["encode_plain"] = measure(
            "encode_plain", lambda: emit.encode_plain(*args), lambda: bt.encode_plain_ref(*args),
            c * (n_sym + 1024 + 8 * n) + 4 * n + _words_out(out[1]), label=label)
        r_args, label = widest_fused_run(long, dev)
        out = emit.encode_run(*r_args)
        _check_words(label, out, bt.encode_run_ref(*r_args))
        wide["encode_run"] = measure(
            "encode_run", lambda: emit.encode_run(*r_args), lambda: bt.encode_run_ref(*r_args),
            r_args[0].shape[0] * (n_sym + 2052 + 8 * n) + 4 * n + _words_out(out[1]),
            label=label)
        t_args, label = widest_tags(long, dev)
        out = emit.pack_tags(*t_args)
        _check_tags(out, _pack_tags(*t_args))
        width = t_args[0].shape[1]
        n_sym = int(t_args[2].long().clamp(max=width).sum())
        wide["pack_tags"] = measure(
            "pack_tags", lambda: emit.pack_tags(*t_args), lambda: _pack_tags(*t_args),
            2 * n_sym + 8 * len(t_args[2]) + 260 + out[0].numel(), label=label)
        for name, m in wide.items():
            res[name].update({f"widest_{k}": m[k] for k in (
                "ms", "warm_ms", "plain_ms", "bound_ms", "event_ms", "bytes")})

    # K9 and K8 on what the emission route gives them at the widest bucket
    from dextractor_tpu_torch.ops import lut
    from dextractor_tpu_torch.parallel import pipeline
    from dextractor_tpu_torch.testing import widest_bucket_batch

    (streams, lengths, sym, run, rchars, _), run_on = widest_bucket_batch(long)
    step_in = [torch.from_numpy(a).to(dev) for a in (streams, lengths, sym, run, rchars)]
    seen = route_inputs(lambda: pipeline.channels_emissions(*step_in, run_on))
    kerns = {"lut_gather": lut.lut_gather_groups, "pack_words": lambda *a: (lut.pack_words(*a),)}
    twins = {"lut_gather": lut.lut_gather_groups_ref,
             "pack_words": lambda *a: (lut.pack_words_ref(*a),)}
    for name in ("lut_gather", "pack_words"):
        res[name] = {"max_abs_err": max(_check_same(name, kerns[name](*a), twins[name](*a))
                                        for a in seen[name])}
    shapes = {"lut_gather": [[(tuple(d.shape), str(d.dtype)) for d, _ in a[0]]
                             for a in seen["lut_gather"]],
              "pack_words": [tuple(a[0].shape) for a in seen["pack_words"]]}
    log(f"[kernel] lut_gather on {shapes['lut_gather']} (one launch) and pack_words on "
        f"{shapes['pack_words']} (the emission route at the widest long-read bucket, "
        f"streams {tuple(streams.shape)}, run_on {run_on}) bit-identical to their twins")
    if on_card(dev):
        groups, luts = seen["lut_gather"][0]
        res["lut_gather"].update(measure(
            "lut_gather", lambda: lut.lut_gather_groups(groups, luts),
            lambda: lut.lut_gather_groups_ref(groups, luts), _groups_bytes(groups, luts),
            label=f"lut_gather (widest long-read bucket, {len(groups)} lookups in one launch)"))
        # one lookup alone, beside the one PyTorch call that computes it
        g = next(([(d, k)], luts) for d, k in groups if d.dtype == torch.uint8)
        idx = g[0][0][0].long()
        table = luts[g[0][0][1]]
        one = measure("lut_gather", lambda: lut.lut_gather_groups(*g),
                      lambda: lut.lut_gather_groups_ref(*g), _groups_bytes(*g),
                      library=lambda: torch.take(table, idx),
                      label=f"lut_gather (one lookup, {tuple(idx.shape)} u8)")
        res["lut_gather"].update({f"one_{k}": one[k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "event_ms", "bytes", "library_ms")})
        pw = max(seen["pack_words"], key=lambda a: a[0].shape[1])
        rows, m = pw[0].shape
        res["pack_words"].update(measure(
            "pack_words", lambda: lut.pack_words(*pw), lambda: lut.pack_words_ref(*pw),
            8 * rows * m + 4 * rows * (m + 1),
            label=f"pack_words (widest long-read bucket, {rows} x {m} slots)"))
        # and at the narrowest bucket the emission route takes, where K8 has
        # the most rows of the route and the fewest slots
        pw, label = narrowest_pack_words(long, dev)
        _check_same(label, (lut.pack_words(*pw),), (lut.pack_words_ref(*pw),))
        rows, m = pw[0].shape
        narrow = measure("pack_words", lambda: lut.pack_words(*pw),
                         lambda: lut.pack_words_ref(*pw), 8 * rows * m + 4 * rows * (m + 1),
                         label=label)
        res["pack_words"].update({f"narrow_{k}": narrow[k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "event_ms", "bytes")})

    def wide_emissions():
        (e,) = lut.lut_gather_groups([(dd, 0)], conc)
        v, n, _, _ = bt.plain_emissions(dd, wld, e)
        bt.pack_words_any(v, n)
        setup = bt.run_setup(dd, wld, rch[0].long())
        sym_e, run_e = lut.lut_gather_groups([(dd, 0), (setup.index, 1)],
                                             torch.stack([sym_d[0], run_d[0]]))
        v, n, _, _ = bt.run_assemble(dd, setup, sym_e, run_e, run_d[0])
        bt.pack_words_any(v, n)

    edges = route_inputs(wide_emissions)
    lut_in, pack_in = emission_edges(dev, wide_len)
    edges["lut_gather"] += lut_in
    edges["pack_words"] += pack_in
    for name in ("lut_gather", "pack_words"):
        res[name]["max_abs_err"] = max([res[name]["max_abs_err"]] + [
            _check_same(name, kerns[name](*a), twins[name](*a)) for a in edges[name]])
    log(f"[kernel] emission edges: lut_gather on every u8 and run index 0-255 alone, on "
        f"groups of 0 and 1 elements, unaligned views and u8 and int32 in one launch, on "
        f"nine groups, and on the lookups of wide rows {tuple(d.shape)} ({runs}, type-2 "
        f"escapes), pack_words on their emissions "
        f"({[tuple(a[0].shape) for a in edges['pack_words']]}: 0 slots, all-zero widths, "
        "straddling 32-bit emissions) bit-identical to their twins")
    return res


def corpora(uniform: bytes, long: bytes):
    import numpy as np
    from dextractor_tpu_torch.testing import make_quiva

    sub_heavy = make_quiva(np.random.default_rng(7), n_reads=120,
                           min_len=1900, max_len=2100, sub_heavy=True)
    return [("uniform", uniform, False), ("sub_heavy", sub_heavy, False),
            ("sub_heavy_lossy", sub_heavy, True), ("long_reads", long, False)]


def route_counts(q, coding):
    """The kernel calls that encoding .quiva ``q`` with ``coding`` on the
    device must make when every bucket takes the route ``fused_ok`` gives
    its width: {kernel: calls}, and the numbers of buckets per route."""
    from dextractor_tpu_torch.codecs.qv_codec import encode_buckets, step_tables
    from dextractor_tpu_torch.ops.emit import fused_ok

    widths = [w for w, _ in encode_buckets(q.lengths)]
    n_fused = sum(map(fused_ok, widths))
    n_em = len(widths) - n_fused
    n_run = sum(step_tables(coding)[4])
    return {"encode_plain": n_fused, "encode_run": n_fused if n_run else 0,
            "pack_tags": len(widths), "lut_gather": n_em,
            "pack_words": n_em * (1 + (n_run > 0))}, n_fused, n_em


def _stage_line():
    from dextractor_tpu_torch.utils.profiling import REPORTER

    return ", ".join(f"{st.name} {st.seconds:.4f}" for st in REPORTER.stages.values())


def _counts():
    from dextractor_tpu_torch.utils import dispatch

    return dict(dispatch.LAUNCHES), dict(dispatch.TWIN_CALLS)


def phase_encode_slice(device, cases):
    """The encode path end to end on ``device`` against the native C
    encoder.  Returns (launch counts, twin calls, [(name, quiva, lossy,
    dexqv)])."""
    from dextractor_tpu_torch.codecs.qv_codec import (create_qvcoding,
                                                      encode_quiva_to_dexqv, qv,
                                                      scan_quiva)
    from dextractor_tpu_torch.utils import dispatch
    from dextractor_tpu_torch.utils.profiling import REPORTER

    encoded = []
    card = dispatch.resolve_device(device).type == "cuda"
    dispatch.reset_counts()
    for name, data, lossy in cases:
        q = qv.parse_quiva(data)
        coding = create_qvcoding(scan_quiva(q), q.prefix, lossy)
        if name.startswith("sub_heavy") and (coding.drun_scheme is None
                                             or coding.srun_scheme is None):
            raise AssertionError(f"{name}: delQV and subQV must both be RLE")
        expect, n_fused, n_em = route_counts(q, coding)
        if name == "uniform" and n_em:
            raise AssertionError("the uniform batch must encode through K1-K3 only")
        before = dict(dispatch.LAUNCHES if card else dispatch.TWIN_CALLS)
        REPORTER.stages.clear()
        REPORTER.enabled = True
        t0 = time.perf_counter()
        got = encode_quiva_to_dexqv(data, lossy=lossy, device=device)
        t1 = time.perf_counter()
        REPORTER.enabled = False
        ref = encode_quiva_to_dexqv(data, lossy=lossy, device=False)
        t2 = time.perf_counter()
        if got != ref:
            raise AssertionError(f"{name}: device bytes differ from the native encoder")
        after = dispatch.LAUNCHES if card else dispatch.TWIN_CALLS
        calls = {k: after[k] - before[k] for k in expect}
        if calls != expect:
            raise AssertionError(f"{name}: kernel calls {calls}, the routes of its "
                                 f"buckets by fused_ok give {expect}")
        encoded.append((name, data, lossy, got))
        log(f"[encode] {name}: {q.n_entries} reads, {int(q.lengths.sum())} "
            f"symbols/channel, max read {int(q.lengths.max())}, "
            f"{len(got)} bytes identical to native; {n_fused} buckets through K1/K2, "
            f"{n_em} through K9/K8, kernel calls {calls}; device {t1 - t0:.3f} s, "
            f"native {t2 - t1:.3f} s (host clock); device stages (s): {_stage_line()}")
    launches, twins = _counts()
    log(f"[encode] launches {launches} twin calls {twins}")
    return launches, twins, encoded


def encode_long_totals(long: bytes):
    """Device time of each encode kernel over one
    encode_quiva_to_dexqv(device=True) of the long-read batch (profiler):
    its launches times its time on the main path.  As in phase_decode_long,
    one trace holds two encodes and the second one's device operations are
    counted; a trace that holds fewer launches of a kernel than the launch
    counters saw is taken again, up to three times, and the line says how
    many it holds.  K9 must have launched once per emission bucket."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from dextractor_tpu_torch.codecs.qv_codec import encode_buckets, encode_quiva_to_dexqv
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.ops.emit import fused_ok
    from dextractor_tpu_torch.utils import dispatch

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            encode_quiva_to_dexqv(long, device="cuda")
            torch.cuda.synchronize()
            before = dict(dispatch.LAUNCHES)
            with record_function("second_encode"):
                encode_quiva_to_dexqv(long, device="cuda")
                torch.cuda.synchronize()
        launched = {k: dispatch.LAUNCHES[k] - before[k] for k in ENCODE_KERNELS}
        cuda = torch.autograd.DeviceType.CUDA
        mark = min(e.time_range.start for e in prof.events()
                   if e.name == "second_encode" and e.device_type != cuda)
        ev = [e for e in prof.events() if e.device_type == cuda
              and e.name != "second_encode" and e.time_range.start >= mark]
        traced = {k: [e.time_range.elapsed_us() / 1000 for e in ev if f"{k}_kernel" in e.name]
                  for k in ENCODE_KERNELS}
        if all(len(traced[k]) == launched[k] for k in ENCODE_KERNELS):
            break
        log(f"[profiler] a trace of the long-read encode holds "
            f"{ {k: len(v) for k, v in traced.items()} } of its launches {launched}; "
            "tracing again")
    parts = [f"{k} {sum(traced[k])} ms in {len(traced[k])} of {launched[k]} launches "
             f"(mean {sum(traced[k]) / max(1, len(traced[k]))} ms)" for k in ENCODE_KERNELS]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1000
    log(f"[encode long] long-read batch, device time of each encode kernel (profiler, the "
        f"second of two encodes in one trace): {'; '.join(parts)}; all device ops {busy} ms")
    # K9 takes every lookup of an emission bucket in one launch
    n_em = sum(not fused_ok(w) for w, _ in encode_buckets(parse_quiva(long).lengths))
    if launched["lut_gather"] != n_em:
        raise AssertionError(f"the long-read encode launched lut_gather "
                             f"{launched['lut_gather']} times, expected one per emission "
                             f"bucket: {n_em}")


def phase_encode_step(device, uniform: bytes, long: bytes):
    import torch
    from dextractor_tpu_torch.parallel import pipeline
    from dextractor_tpu_torch.parallel.pipeline import qv_encode_step
    from dextractor_tpu_torch.testing import step_batch, widest_bucket_batch

    # the widest long-read bucket through both routes: the same words
    (streams, lengths, sym, run, rchars, _), run_on = widest_bucket_batch(long)
    w_in = [torch.from_numpy(a).to(device) for a in (streams, lengths, sym, run, rchars)]
    routes = {"K1/K2": pipeline.channels_fused, "K9/K8": pipeline.channels_emissions}
    outs = {k: fn(*w_in, run_on) for k, fn in routes.items()}
    (wf, tf, lf), (we, te, le) = outs.values()
    raw = (tf.long() + 31) >> 5
    if (wf.shape != we.shape or not torch.equal(tf, te) or not torch.equal(lf, le)
            or not torch.equal(_masked(wf, raw), _masked(we, raw))):
        raise AssertionError("the two encode routes disagree on the widest long-read bucket")
    if on_card(device):
        payload = 4 * int(lengths.sum())
        for k, fn in routes.items():
            ms = cuda_ms(lambda: fn(*w_in, run_on), reps=5, rounds=5)
            busy, n_ops = device_ms(lambda: fn(*w_in, run_on), reps=5)
            log(f"[encode step] widest long-read bucket, streams {tuple(streams.shape)}, "
                f"run_on {run_on}, four QV channels through {k}: {ms} ms median (CUDA "
                f"events), {payload / ms / 1e6} GB/s of {payload} payload bytes; device "
                f"busy {busy} ms in {n_ops} device ops (profiler)")

    args, run_on = step_batch(uniform)
    dargs = [torch.from_numpy(a).to(device) for a in args]
    payload = 5 * int(args[1].sum())
    out = qv_encode_step(*dargs, run_on=run_on)
    if out[0].device.type != torch.device(device).type or out[0].shape[:2] != (4, len(args[1])):
        raise AssertionError("the encode step did not run where its inputs lie")
    if not on_card(device):
        return
    ms = cuda_ms(lambda: qv_encode_step(*dargs, run_on=run_on))
    busy, n_ops = device_ms(lambda: qv_encode_step(*dargs, run_on=run_on))
    share = "not measured" if busy is None else f"{busy / ms:.3f}"
    log(f"[encode step] qv_encode_step streams {tuple(args[0].shape)} run_on {run_on}: "
        f"{ms} ms median (CUDA events), {payload / ms / 1e6} GB/s of "
        f"{payload} payload bytes; device busy {busy} ms in {n_ops} device "
        f"ops (profiler), busy share {share}")
    encode_long_totals(long)


def _repeat_interleave(runs, lits, rchar: int):
    """One torch.repeat_interleave computing K6's rows as a flat stream:
    the (rchar, literal) pairs of every token repeated (run, 1) times."""
    import torch

    vals = torch.stack([torch.full_like(lits, rchar & 0xFF), lits], 2).reshape(-1)
    counts = torch.stack([runs, (lits >= 0).to(torch.int32)], 2).reshape(-1)
    total = int(counts.sum())
    return lambda: torch.repeat_interleave(vals, counts, output_size=total)


def _expand_bytes(runs, lits, out):
    """Bytes K6 must move for tokens (runs, lits) and its outputs ``out``:
    each row's tokens up to its last live one (a nonzero run or a literal),
    with the tag codes one code of 2 bits per literal, and every output
    column written once."""
    import torch

    col = torch.arange(1, runs.shape[1] + 1, device=runs.device)
    n_tok = torch.where((runs > 0) | (lits >= 0), col, 0).amax(1)
    nbytes = 8 * int(n_tok.sum()) + out[0].numel()
    if out[1] is not None:
        nbytes += int(((lits >= 0).sum(1) + 3).div(4, rounding_mode="floor").sum())
        nbytes += out[1].numel()
    return nbytes


def phase_decode_kernels(device, encoded, long_len: int = 70_000, row_len: int = 2500):
    """K4-K6 against their twins on ``device`` at the uniform batch's decode
    shapes, K5/K6 on the sub-heavy corpus's subQV, the edge rows of
    ``decode_edge_cases(long_len, row_len)``, K6 on
    ``expand_edge_cases(min(9000, long_len), long_len)`` (with rows of
    ``long_len`` from 66,000 on) and on decode_ablate's random tokens; on
    the card also their times at the uniform shapes.  ``encoded`` is
    phase_encode_slice's list.  Returns {kernel: {max_abs_err, times...}}."""
    import numpy as np
    import torch
    from dextractor_tpu_torch.ops import decode2 as d2
    from dextractor_tpu_torch.ops import decode_chains as dch
    from dextractor_tpu_torch.ops import expand
    from dextractor_tpu_torch.testing import (batch_to, check_decode_case, decode_batch,
                                              decode_edge_cases, expand_edge_cases)
    from dextractor_tpu_torch.tools.decode_ablate import expand_tokens

    dev = torch.device(device)
    by_name = {name: enc for name, _, _, enc in encoded}
    twins = {"decode_plain": d2.plain_chains, "decode_run": d2.run_chain,
             "expand_runs": expand.expand_runs_ref}
    wrappers = {"decode_plain": dch.decode_plain, "decode_run": dch.decode_run,
                "expand_runs": expand.expand_runs}
    errs = dict.fromkeys(DECODE_KERNELS, 0)
    res = {}

    def run(name, args, kw, label, nbytes=None, library=None, key=None):
        """Check wrapper ``name`` against its twin; with ``nbytes``, time it
        on the card into res[key or name]."""
        out = wrappers[name](*args, **kw)
        errs[name] = max(errs[name], _check_same(f"{name} ({label})", out,
                                                 twins[name](*args, **kw)))
        log(f"[kernel] {name} ({label}) bit-identical to twin")
        if nbytes is not None and on_card(dev):
            res[key or name] = measure(name, lambda: wrappers[name](*args, **kw),
                                       lambda: twins[name](*args, **kw), nbytes(out),
                                       slow_twin=True, library=library, label=key)
        return out

    args, kw = decode_batch(by_name["uniform"])
    if (kw["del_mode"], kw["sub_mode"]) != ("run", "plain"):
        raise AssertionError("the uniform batch decodes delQV as runs, subQV plain")
    rd, tg, ri, rm, rs, rl, sids, f1, f2, types, dc, sc = batch_to(args, dev)
    sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
    n, max_len, lmax = rl.shape[0], kw["max_len"], kw["lmax"]
    l2_bytes = 4 * f2.numel() if max(sw) else 0
    shape = f"{n} rows, max_len {max_len}, lmax {lmax}"

    def plain_bytes(out):
        c = out[1].shape[0]
        return (_words_out(out[1]) + 4 * n + c * 1024 + l2_bytes + out[0].numel()
                + 8 * out[1].numel())

    plain = [2, 3, 4]
    run("decode_plain",
        ([ri, rm, rs], rl, torch.stack([f1[sids[k]] for k in plain]), f2,
         [sig[k] for k in plain], [sw[k] for k in plain]),
        dict(max_len=max_len, lmax=lmax), f"ins, mrg, sub in one launch, {shape}",
        plain_bytes)
    run("decode_plain", ([ri], rl, f1[sids[2]][None], f2, [sig[2]], [sw[2]]),
        dict(max_len=max_len, lmax=lmax), f"ins alone, {shape}", plain_bytes,
        key="decode_plain (C = 1)")
    dkw = dict(max_tokens=kw["max_tokens"], subw=max(sw[0], sw[1]), lmax=lmax)
    runs, lits, _, _ = run(
        "decode_run", (rd, rl, f1[sids[1]], f1[sids[0]], f2, sig[0]), dkw,
        f"delQV, {shape}, max_tokens {kw['max_tokens']}",
        lambda out: _words_out(out[2]) + 4 * n + 2048 + l2_bytes
        + 4 * (out[0].numel() + out[1].numel() + 2 * n))
    run("expand_runs", (runs, lits, dc), dict(max_len=max_len, tag_bytes=tg),
        f"delQV with the delTag codes, {shape}", lambda out: _expand_bytes(runs, lits, out),
        library=_repeat_interleave(runs, lits, dc))

    args, kw = decode_batch(by_name["sub_heavy"])
    if kw["sub_mode"] != "run":
        raise AssertionError("the sub-heavy corpus decodes subQV as runs")
    rd, tg, ri, rm, rs, rl, sids, f1, f2, types, dc, sc = batch_to(args, dev)
    sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
    runs, lits, _, _ = run(
        "decode_run", (rs, rl, f1[sids[5]], f1[sids[4]], f2, sig[4]),
        dict(max_tokens=kw["max_tokens"], subw=max(sw[4], sw[5]), lmax=kw["lmax"]),
        f"subQV of the sub-heavy corpus, {rl.shape[0]} rows")
    run("expand_runs", (runs, lits, sc), dict(max_len=kw["max_len"]),
        "subQV of the sub-heavy corpus")

    rng = np.random.default_rng(3)
    l2_lens = []           # L2 entries of each edge case whose chains read L2
    for label, name, a, k, expect in decode_edge_cases(dev, long_len, row_len):
        reads_l2 = max(a[5]) if name == "decode_plain" else k["subw"]
        if reads_l2:
            l2_lens.append(a[3 if name == "decode_plain" else 4].numel())
        out = run(name, a, k, f"edge: {label}")
        check_decode_case(label, out, expect)
        if name == "decode_run":
            # chains cut at a third of their tokens; K6 on the whole tokens, with tags
            run(name, a, dict(k, max_tokens=k["max_tokens"] // 3),
                f"edge: {label}, max_tokens {k['max_tokens'] // 3}")
            tb = torch.from_numpy(rng.integers(0, 256, (out[0].shape[0], 64),
                                               dtype=np.uint8)).to(dev)
            width = expect["rows"].shape[1]
            run("expand_runs", (out[0], out[1], expect["rchar"]),
                dict(max_len=width, tag_bytes=tb), f"edge: {label}, with tag codes")
    # the chain kernels stage L2 in shared memory up to SMEM_L2_MAX entries
    # and read it from global memory past that: the edge rows take both
    if not (min(l2_lens) <= dch.SMEM_L2_MAX < max(l2_lens)):
        raise AssertionError(f"edge rows with L2 tables of {sorted(l2_lens)} entries do "
                             f"not take both sides of {dch.SMEM_L2_MAX}")
    log(f"[kernel] decode edge rows ({long_len}-symbol rows, L2 tables of "
        f"{sorted(set(l2_lens))} entries): K4, K5, K6 bit-identical to their twins "
        "and to the encoded data")
    cases = expand_edge_cases(min(9000, long_len), long_len if long_len >= 66_000 else 0)
    for label, er, el, rc, ml, etb in cases:
        run("expand_runs", (torch.from_numpy(er).to(dev), torch.from_numpy(el).to(dev), rc),
            dict(max_len=ml, tag_bytes=None if etb is None else torch.from_numpy(etb).to(dev)),
            f"edge: {label}, {er.shape[1]} tokens a row")
    ntoks = rng.integers(row_len // 5, row_len // 4, 40)
    ar, al = (torch.from_numpy(x).to(dev) for x in expand_tokens(ntoks, 48, row_len // 4))
    for ml in (row_len, row_len // 3 + 5):
        run("expand_runs", (ar, al, ord("n")), dict(max_len=ml),
            f"decode_ablate's random tokens, max_len {ml}")
    for name in DECODE_KERNELS:
        res.setdefault(name, {})["max_abs_err"] = errs[name]
    return res


@contextlib.contextmanager
def decode_route(segmented: bool):
    """Within the block, decode_dexqv_to_quiva takes the segmented route (the
    default) or the per-read route (DXT_SEG_DECODE=0); yields {route: calls
    of its batch decode}."""
    from dextractor_tpu_torch.codecs import qv_batch

    calls = {"segmented": 0, "per_read": 0}
    saved = (os.environ.get("DXT_SEG_DECODE"), qv_batch.fused_decode_entries_seg,
             qv_batch.fused_decode_entries)

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    os.environ["DXT_SEG_DECODE"] = "1" if segmented else "0"
    qv_batch.fused_decode_entries_seg = counted("segmented", saved[1])
    qv_batch.fused_decode_entries = counted("per_read", saved[2])
    try:
        yield calls
    finally:
        env, qv_batch.fused_decode_entries_seg, qv_batch.fused_decode_entries = saved
        if env is None:
            os.environ.pop("DXT_SEG_DECODE", None)
        else:
            os.environ["DXT_SEG_DECODE"] = env


def phase_decode_slice(device, encoded, segmented: bool = True):
    """decode_dexqv_to_quiva on ``device`` against the original .quiva and
    the native walker, through the segmented route (taken by a file with a
    read over 2,048 symbols, as every corpus of the card's run has) or the
    per-read route.  Returns (launch counts, twin calls)."""
    from dextractor_tpu_torch.codecs.qv_codec import SEG_DECODE, decode_dexqv_to_quiva
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.testing import lossy_quiva
    from dextractor_tpu_torch.utils import dispatch
    from dextractor_tpu_torch.utils.profiling import REPORTER

    dispatch.reset_counts()
    for name, data, lossy, enc in encoded:
        long_read = int(parse_quiva(data).lengths.max(initial=0)) > SEG_DECODE
        route = "segmented" if segmented and long_read else "per_read"
        REPORTER.stages.clear()
        REPORTER.enabled = True
        with decode_route(segmented) as calls:
            t0 = time.perf_counter()
            got = decode_dexqv_to_quiva(enc, device=device)
            t1 = time.perf_counter()
        REPORTER.enabled = False
        if calls != {k: int(k == route) for k in calls}:
            raise AssertionError(f"{name}: the {route} route was not taken: {calls}")
        ref = decode_dexqv_to_quiva(enc, device=False)
        t2 = time.perf_counter()
        want = lossy_quiva(data) if lossy else data
        if got != ref or got != want:
            raise AssertionError(f"{name}: decoded bytes differ from the "
                                 f"{'native walker' if got != ref else 'original'}")
        log(f"[decode] {name} ({route} route): {len(enc)} bytes -> {len(got)} bytes "
            f"identical to the {'quantised ' if lossy else ''}original and to the native "
            f"walker; device {t1 - t0:.3f} s, native {t2 - t1:.3f} s (host clock); "
            f"device stages (s): {_stage_line()}")
    launches, twins = _counts()
    log(f"[decode] {'segmented' if segmented else 'per-read'} route: launches "
        f"{launches} twin calls {twins}")
    return launches, twins


def phase_decode_step(device, dexqv: bytes):
    import torch
    from dextractor_tpu_torch.ops.decode2 import decode_entry_batch2
    from dextractor_tpu_torch.testing import batch_to, decode_batch

    args, kw = decode_batch(dexqv)
    dargs = batch_to(args, device)
    rows = decode_entry_batch2(*dargs, **kw)
    n = len(args[5])
    if rows.device.type != torch.device(device).type or rows.shape != (5, n, kw["max_len"]):
        raise AssertionError("the decode step did not run where its inputs lie")
    if not on_card(device):
        return
    payload = 5 * int(args[5].sum())
    ms = cuda_ms(lambda: decode_entry_batch2(*dargs, **kw), reps=5, rounds=5)
    busy, n_ops = device_ms(lambda: decode_entry_batch2(*dargs, **kw), reps=5)
    share = "not measured" if busy is None else f"{busy / ms:.3f}"
    log(f"[decode step] decode_entry_batch2 {n} rows, max_len {kw['max_len']}, "
        f"max_tokens {kw['max_tokens']}, {kw['del_mode']}/{kw['sub_mode']}: {ms} ms "
        f"median (CUDA events), {payload / ms / 1e6} GB/s of {payload} payload "
        f"bytes; device busy {busy} ms in {n_ops} device ops (profiler), busy "
        f"share {share}")


def phase_decode_long(device, dexqv: bytes):
    """Device time of each decode kernel over one
    decode_dexqv_to_quiva(device=True) of the long-read batch on the
    segmented route and on the per-read route, where every read is one
    chain per channel (profiler), and the host-clock time.

    Traces of this decode have dropped kernel launches, the more often the
    fewer launches a kernel has in it (the segmented route's one launch per
    kernel came back missing in most traces).  So one trace holds two
    decodes, and the device operations that start after the second one's
    marker are its; a trace that holds fewer launches of a kernel than the
    launch counters saw the second decode make is taken again, up to three
    times, and the line says how many it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from dextractor_tpu_torch.codecs.qv_codec import decode_dexqv_to_quiva
    from dextractor_tpu_torch.utils import dispatch

    if not on_card(device):
        return
    for segmented in (True, False):
        with decode_route(segmented):
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    decode_dexqv_to_quiva(dexqv, device=device)
                    torch.cuda.synchronize()
                    before = dict(dispatch.LAUNCHES)
                    t0 = time.perf_counter()
                    with record_function("second_decode"):
                        decode_dexqv_to_quiva(dexqv, device=device)
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                launched = {k: dispatch.LAUNCHES[k] - before[k] for k in DECODE_KERNELS}
                cuda = torch.autograd.DeviceType.CUDA
                mark = min(e.time_range.start for e in prof.events()
                           if e.name == "second_decode" and e.device_type != cuda)
                # the marker's own span on the device timeline is no operation
                ev = [e for e in prof.events() if e.device_type == cuda
                      and e.name != "second_decode" and e.time_range.start >= mark]
                traced = {k: [e.time_range.elapsed_us() / 1000 for e in ev
                              if f"{k}_kernel" in e.name] for k in DECODE_KERNELS}
                if all(len(traced[k]) == launched[k] for k in DECODE_KERNELS):
                    break
                log(f"[profiler] a trace of the long-read decode holds "
                    f"{ {k: len(v) for k, v in traced.items()} } of its launches "
                    f"{launched}; tracing again")
        parts = [f"{k} {sum(traced[k])} ms in {len(traced[k])} of {launched[k]} launches "
                 f"(longest {max(traced[k], default=0)} ms)" for k in DECODE_KERNELS]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1000
        route = ("segmented route, chains of at most 2,048 symbols" if segmented
                 else "per-read route, one chain per read and channel")
        log(f"[decode long] long-read batch, {route}: device time (profiler, the second "
            f"of two decodes in one trace) {'; '.join(parts)}; all device ops {busy} ms; "
            f"host clock {wall:.3f} s with the profiler on")


def twobit_edge_reads(long_len: int = 70_000, seed: int = 17):
    """Flat reads of lengths 0-7, one of ``long_len`` bases, one of every
    byte value in order, and a few more, of random bytes 0-255; and their
    lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, 2, 3, 4, 5, 6, 7, long_len, 256, 3, 0, 1021, 9, 0],
                       np.int64)
    flat = rng.integers(0, 256, int(lengths.sum()), dtype=np.uint8)
    at = int(lengths[:9].sum())
    flat[at:at + 256] = np.arange(256)
    return flat, lengths


def _twobit_args(flat, lengths, table, device, lead: int = 0):
    """(flat, offsets, out_offsets, table, n_out) of pack2bit on ``device``
    for the flat reads ``flat[lead:]`` of ``lengths``: the reads' offsets
    start at ``lead``, into the whole buffer."""
    import numpy as np
    import torch

    offs = np.full(len(lengths) + 1, lead, np.int64)
    np.cumsum(lengths, out=offs[1:])
    offs[1:] += lead
    couts = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum((lengths + 3) >> 2, out=couts[1:])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (flat, offs, couts, table)) + (int(couts[-1]),)


def _host_s(fn, rounds: int = 5) -> float:
    """Median host-clock seconds of fn() followed by a synchronize."""
    import torch

    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_twobit_kernels(device, cases, long_len: int = 70_000):
    """K7 (pack2bit) and the unpack against their twins on ``device``, on the
    flat reads of each corpus of ``cases`` ([(name, text, arrow)], the
    uniform .fasta first), on ``twobit_edge_reads(long_len)`` and on
    ``testing.twobit_tile_edges()`` with every table, and the unpack on
    ``testing.twobit_letter_tile_edges()`` with every letter table; on the
    card also both kernels' times at each corpus's shapes (see
    ``measure``).  Returns {kernel: {max_abs_err, times...}}."""
    import numpy as np
    import torch
    from dextractor_tpu_torch.formats.fasta import parse_seq_file
    from dextractor_tpu_torch.ops import pack2bit as pk
    from dextractor_tpu_torch.ops import twobit as tb
    from dextractor_tpu_torch.testing import twobit_letter_tile_edges, twobit_tile_edges

    rng = np.random.default_rng(5)
    tables = {"base": tb.NUMBER_BASE_LUT, "arrow": tb.NUMBER_ARROW_LUT,
              "random": rng.integers(0, 4, 256).astype(np.uint8)}
    letters = {"lower": tb.LOWER_LUT, "upper": tb.UPPER_LUT, "arrow": tb.ARROW_LETTER_LUT}
    res = {}

    def pack_twin(flat, offs, couts, lut, n_out):
        return tb.pack2bit_twin(flat[int(offs[0]):], offs.diff(), lut)

    def unpack_twin(pay, pay_offs, outs, lut, n_out):
        return tb.unpack2bit_twin(pay[int(pay_offs[0]):], outs.diff(), lut)

    def check(name, kern, twin, args):
        got, ref = kern(*args), twin(*args)
        err = _check_same(name, (got,), (ref,))
        r = res.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        return got

    def unpack_args(pargs, payload, letter_lut, n_letters):
        """unpack2bit's arguments for pack2bit's ``pargs`` and output: the
        payload offsets are pack2bit's out_offsets, the letters' offsets
        pack2bit's offsets from 0."""
        return (payload, pargs[2], pargs[1] - pargs[1][0],
                torch.from_numpy(letter_lut).to(device), n_letters)

    for i, (name, text, arrow) in enumerate(cases):
        f = parse_seq_file(text, arrow=arrow)
        lengths = f.seqs.lengths.astype(np.int64)
        n, n_sym = len(lengths), int(lengths.sum())
        table, letter = (tables["arrow"], letters["arrow"]) if arrow else (tables["base"],
                                                                           letters["lower"])
        pargs = _twobit_args(f.seqs.flat, lengths, table, device)
        payload = check("pack2bit", pk.pack2bit, pack_twin, pargs)
        uargs = unpack_args(pargs, payload, letter, n_sym)
        check("unpack2bit", pk.unpack2bit, unpack_twin, uargs)
        log(f"[kernel] pack2bit, unpack2bit: {name}, {n} reads, {n_sym} bases, {pargs[4]} "
            "payload bytes, bit-identical to their twins")
        if not on_card(device):
            continue
        offsets = 2 * 8 * (n + 1)
        m = measure("pack2bit", lambda: pk.pack2bit(*pargs), lambda: pack_twin(*pargs),
                    n_sym + offsets + 256 + pargs[4], label=f"pack2bit ({name})")
        res["pack2bit"].update(m if i == 0 else {f"{name}_{k}": m[k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "event_ms", "bytes")})
        m = measure("unpack2bit", lambda: pk.unpack2bit(*uargs), lambda: unpack_twin(*uargs),
                    pargs[4] + offsets + 4 + n_sym, label=f"unpack2bit ({name})")
        res["unpack2bit"].update(m if i == 0 else {f"{name}_{k}": m[k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "event_ms", "bytes")})
        if i:
            continue
        h2d = _host_s(lambda: torch.from_numpy(f.seqs.flat).to(device))
        d2h = _host_s(lambda: payload.cpu())
        log(f"[2-bit copies] host clock, pageable memory: H2D of the {n_sym} bases "
            f"{h2d} s ({n_sym / h2d / 1e9} GB/s), D2H of the {pargs[4]} payload bytes "
            f"{d2h} s ({pargs[4] / d2h / 1e9} GB/s)")

    flat, lengths = twobit_edge_reads(long_len)
    for table in tables.values():
        pargs = _twobit_args(flat, lengths, table, device)
        payload = check("pack2bit", pk.pack2bit, pack_twin, pargs)
        for letter_lut in letters.values():
            check("unpack2bit", pk.unpack2bit, unpack_twin,
                  unpack_args(pargs, payload, letter_lut, int(lengths.sum())))
    log(f"[kernel] 2-bit edge reads (lengths {lengths.tolist()}, every byte value): "
        f"pack2bit with the {', '.join(tables)} tables and unpack2bit with the "
        f"{', '.join(letters)} letters bit-identical to their twins")
    edges = twobit_tile_edges()
    for label, flat, lengths, lead in edges:
        for table in tables.values():
            # the reads start ``lead`` bytes into the flat buffer on the device
            pargs = _twobit_args(flat, lengths, table, device, lead)
            check("pack2bit", pk.pack2bit, pack_twin, pargs)
    log(f"[kernel] pack2bit tile edges ({'; '.join(e[0] for e in edges)}) with the "
        f"{', '.join(tables)} tables bit-identical to its twin")
    edges = twobit_letter_tile_edges()
    for label, payload, lengths, lead in edges:
        pay_offs = lead + np.concatenate([[0], np.cumsum((lengths + 3) >> 2)])
        outs = np.concatenate([[0], np.cumsum(lengths)])
        dev_args = [torch.from_numpy(a).to(device) for a in (payload, pay_offs, outs)]
        for letter_lut in letters.values():
            # the payloads start ``lead`` bytes into the buffer on the device
            check("unpack2bit", pk.unpack2bit, unpack_twin,
                  (*dev_args, torch.from_numpy(letter_lut).to(device), int(outs[-1])))
    log(f"[kernel] unpack2bit letter tile edges ({'; '.join(e[0] for e in edges)}) with "
        f"the {', '.join(letters)} letters bit-identical to its twin")
    return res


def twobit_corpora():
    from dextractor_tpu_torch.testing import long_fasta, uniform_arrow, uniform_fasta

    return [("uniform_fasta", uniform_fasta(), False),
            ("long_fasta", long_fasta(), False),
            ("uniform_arrow", uniform_arrow(), True)]


def _sequence_lines(text: bytes):
    return [line for line in text.split(b"\n") if not line.startswith(b">")]


def phase_twobit_slice(device, cases):
    """The 2-bit codecs end to end on ``device``: each encode against the
    native host path (device=False), each decode against the original text
    and the native path; on the card both 2-bit kernels must launch for
    every corpus.  ``cases`` is [(name, text, arrow)].  Returns (launch
    counts, twin calls)."""
    from dextractor_tpu_torch.codecs import twobit_codec as tc
    from dextractor_tpu_torch.utils import dispatch
    from dextractor_tpu_torch.utils.profiling import REPORTER

    def timed(fn, *args, **kw):
        REPORTER.stages.clear()
        REPORTER.enabled = True
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds = time.perf_counter() - t0
        REPORTER.enabled = False
        return out, seconds, _stage_line()

    card = dispatch.resolve_device(device).type == "cuda"
    dispatch.reset_counts()
    for name, text, arrow in cases:
        before = dict(dispatch.LAUNCHES)
        enc_fn = tc.encode_arrow_to_dexar if arrow else tc.encode_fasta_to_dexta
        dec_fn = tc.decode_dexar_to_arrow if arrow else tc.decode_dexta_to_fasta
        enc, e_dev, e_dev_st = timed(enc_fn, text, device=device)
        ref, e_nat, e_nat_st = timed(enc_fn, text, device=False)
        if enc != ref:
            raise AssertionError(f"{name}: device bytes differ from the native host path")
        dec, d_dev, d_dev_st = timed(dec_fn, enc, device=device)
        nat, d_nat, d_nat_st = timed(dec_fn, enc, device=False)
        # .arrow headers may drift by 0.01 in SN (dexar.c:159-163 truncates):
        # there the sequence lines must equal the original's
        same = (_sequence_lines(dec) == _sequence_lines(text)) if arrow else dec == text
        if dec != nat or not same:
            raise AssertionError(f"{name}: decoded text differs from the "
                                 f"{'native path' if dec != nat else 'original'}")
        idle = [k for k in TWOBIT_KERNELS if dispatch.LAUNCHES[k] <= before[k]]
        if card and idle:
            raise AssertionError(f"{name}: {idle} not launched")
        log(f"[2-bit] {name}: {len(text)} bytes of text -> {len(enc)} bytes identical to "
            f"native -> decoded identical to the {'original sequences' if arrow else 'original'}"
            f" and to native; encode device {e_dev:.4f} s (stages {e_dev_st}), native "
            f"{e_nat:.4f} s (stages {e_nat_st}); decode device {d_dev:.4f} s (stages "
            f"{d_dev_st}), native {d_nat:.4f} s (stages {d_nat_st}) (host clock)")
    launches, twins = _counts()
    log(f"[2-bit] launches {launches} twin calls {twins}")
    return launches, twins


def phase_tag_kernel(device, encoded, long_len: int = 70_000):
    """K10 against its twin on ``device``: on the uniform batch's tag
    rectangle with the state of its decoded delQV rows, where it must also
    give that decode's TAG rows, and on ``testing.tag_edge_cases(long_len)``;
    on the card also its times at the uniform shapes.  Returns {"tag_route":
    {max_abs_err, times...}}."""
    import torch
    from dextractor_tpu_torch.ops import tag
    from dextractor_tpu_torch.ops.decode2 import decode_entry_batch2
    from dextractor_tpu_torch.testing import batch_to, decode_batch, tag_edge_cases

    dev = torch.device(device)
    by_name = {name: enc for name, _, _, enc in encoded}
    args, kw = decode_batch(by_name["uniform"])
    dargs = batch_to(args, dev)
    rows = decode_entry_batch2(*dargs, **kw)
    words = tag.tag_words(dargs[1])
    state = tag.tag_state(rows[0], dargs[5], dargs[10])
    max_len = kw["max_len"]
    cases = [(f"uniform batch, {state.shape[0]} rows, max_len {max_len}, "
              f"{words.shape[1]} tag words", words, state, max_len)]
    cases += tag_edge_cases(dev, long_len)
    err, outs = 0, []
    for label, w, st, width in cases:
        outs.append(tag.tag_route_rows(w, st, max_len=width))
        err = max(err, _check_same(f"tag_route ({label})", outs[-1:],
                                   [tag.tag_route_rows_ref(w, st, max_len=width)]))
        log(f"[kernel] tag_route ({label}) bit-identical to twin")
    if not torch.equal(outs[0], rows[1]):
        raise AssertionError("tag_route on the uniform batch differs from its decode's "
                             "TAG rows")
    log("[kernel] tag_route on the uniform batch equals the TAG rows of its full decode")
    res = {}
    if on_card(dev):
        nbytes = 4 * state.numel() + 4 * words.numel() + outs[0].numel()
        res = measure("tag_route", lambda: tag.tag_route_rows(words, state, max_len=max_len),
                      lambda: tag.tag_route_rows_ref(words, state, max_len=max_len), nbytes,
                      label=f"tag_route ({cases[0][0]})")
    res["max_abs_err"] = err
    return {"tag_route": res}


def phase_decode_ablate(device, mb: int = 16):
    """The port's decode-step phase split (tools/decode_ablate.py) in
    process on ``device``; prints its ABLATE line.  Its tag phase must launch
    K10 (on the CPU: run its twin) and its plain_ins phase K4 with one
    channel.  Returns (launch counts, twin calls) of the whole run."""
    from dextractor_tpu_torch.tools import decode_ablate
    from dextractor_tpu_torch.utils import dispatch

    dispatch.reset_counts()
    results, _ = decode_ablate.run(mb, device=device)
    launches, twins = _counts()
    log("ABLATE: " + json.dumps(results))
    key = "launches" if on_card(device) else "twin_calls"
    for phase, kernel in (("tag", "tag_route"), ("plain_ins", "decode_plain")):
        if results[f"{phase}_{key}"] != {kernel: 1}:
            raise AssertionError(f"decode_ablate's {phase} phase: {key} "
                                 f"{results[f'{phase}_{key}']}, expected one {kernel}")
    log(f"[ablate] launches {launches} twin calls {twins}")
    return launches, twins


def db_corpora():
    """(name, BAM image) of the DB phase: the uniform batch and the
    log-normal long-read batch of PERF.md section 4 as PacBio subreads BAMs."""
    import numpy as np
    from dextractor_tpu_torch import testing

    n = testing.BENCH_MB * 1_000_000 // (5 * testing.UNIFORM_READ_LEN)
    r = testing.UNIFORM_READ_LEN
    return [("uniform", testing.make_bam(np.random.default_rng(0), n_reads=n,
                                         min_len=r - 50, max_len=r + 50, level=1)[0]),
            ("long_reads", testing.make_bam(np.random.default_rng(2),
                                            lengths=testing.lognormal_lengths(),
                                            level=1)[0])]


@contextlib.contextmanager
def db_route(route: str):
    """Within the block, DazzDB.load_all_qventries takes ``route``: "fused"
    (the default, the qvchk track), "walk" (the fused route on the native
    lens walk: the DB's track files must be gone) or "scheme"
    (DXT_DB_FUSED=0).  Yields the channel counts of every decode_plain
    call."""
    from dextractor_tpu_torch.ops import decode_chains

    chans = []
    saved = (os.environ.get("DXT_DB_FUSED"), decode_chains.decode_plain)

    def counted(rects, *args, **kw):
        chans.append(len(rects))
        return saved[1](rects, *args, **kw)

    os.environ["DXT_DB_FUSED"] = "0" if route == "scheme" else "1"
    decode_chains.decode_plain = counted
    try:
        yield chans
    finally:
        env, decode_chains.decode_plain = saved
        if env is None:
            os.environ.pop("DXT_DB_FUSED", None)
        else:
            os.environ["DXT_DB_FUSED"] = env


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _tag_mode(streams, mode: int):
    """Five ascii-mode-1 streams with the delTag in ``mode`` (db/access.py)."""
    from dextractor_tpu_torch.ops import twobit as tb

    out = streams.copy()
    if mode == 2:
        out[1] = out[1] - 32
    elif mode == 0:
        out[1] = tb.NUMBER_BASE_LUT[out[1]]
    return out


def phase_db(device, bams, every: int = 25, workdir: str | None = None):
    """dextract and dex2DB on the BAM images ``bams`` [(name, image)], then
    every route of DazzDB.load_all_qventries on ``device``, held against the
    .quiva streams dextract wrote and the host per-read loader.  The files
    go to ``workdir`` when given (phase 14 loads the DB "both" again), else
    to a temporary directory.  Returns {route: (launch counts, twin
    calls)}."""
    import numpy as np
    from dextractor_tpu_torch.cli import main as tool
    from dextractor_tpu_torch.db import open_db
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.native import hdf5_shim
    from dextractor_tpu_torch.utils import dispatch
    from dextractor_tpu_torch.utils.profiling import REPORTER

    try:
        hdf5_shim()
        log("[db] libhdf5 loaded (the .bax.h5 reader can run on this host)")
    except OSError as e:
        log(f"[db] libhdf5 did not load ({e}); the DB phase reads BAMs only")
    res = {}
    with contextlib.ExitStack() as stack:
        d = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        streams = {}
        for name, image in bams:
            bam = os.path.join(d, f"{name}.subreads.bam")
            with open(bam, "wb") as f:
                f.write(image)
            t0 = time.perf_counter()
            if tool(["dextract", "-f", "-q", "-a", "-eln>=0", bam]) != 0:
                raise AssertionError(f"dextract failed on {name}")
            t1 = time.perf_counter()
            if tool(["dex2DB", "-q", "-eln>=0", os.path.join(d, name), bam]) != 0:
                raise AssertionError(f"dex2DB failed on {name}")
            t2 = time.perf_counter()
            with open(os.path.join(d, f"{name}.quiva"), "rb") as f:
                q = parse_quiva(f.read())
            streams[name] = q.streams
            log(f"[db] {name}: {len(image)} byte BAM, {q.n_entries} reads, "
                f"{int(q.lengths.sum())} symbols/channel; dextract -f -q -a "
                f"{t1 - t0:.3f} s, dex2DB -q {t2 - t1:.3f} s (host clock)")
        names = [n for n, _ in bams]
        t0 = time.perf_counter()
        if tool(["dex2DB", "-q", "-eln>=0", os.path.join(d, "both"),
                 *(os.path.join(d, f"{n}.subreads.bam") for n in names)]) != 0:
            raise AssertionError("dex2DB failed on the two-cell DB")
        log(f"[db] both: dex2DB -q of {len(names)} cells {time.perf_counter() - t0:.3f} s")
        streams["both"] = np.concatenate([streams[n] for n in names], 1)

        def load(db_name, route, mode):
            db = open_db(os.path.join(d, db_name))
            db.open_qvs()
            if len(db._qv.codings) != (len(names) if db_name == "both" else 1):
                raise AssertionError(f"{db_name}: {len(db._qv.codings)} codings")
            dispatch.reset_counts()
            REPORTER.stages.clear()
            REPORTER.enabled = True
            with db_route(route) as chans:
                t0 = time.perf_counter()
                got, rl = db.load_all_qventries(mode, device=device)
                t1 = time.perf_counter()
            REPORTER.enabled = False
            launches, twins = _counts()
            want = _tag_mode(streams[db_name], mode)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{db_name} ({route} route, ascii mode {mode}): "
                                     "streams differ from the .quiva dextract wrote")
            off = np.concatenate([[0], np.cumsum(rl)])
            t2 = time.perf_counter()
            # the per-read loader, a Python bit reader, once a DB and route
            sample = range(0, db.nreads, every) if (db_name, route) not in checked else ()
            checked.add((db_name, route))
            for i in sample:
                if not np.array_equal(db.load_qventry(i, mode), got[:, off[i]:off[i + 1]]):
                    raise AssertionError(f"{db_name} ({route} route, ascii mode {mode}): "
                                         f"read {i} differs from load_qventry")
            t3 = time.perf_counter()
            # the fused route decodes ins, mrg (and plain sub) in one K4
            # launch, the per-scheme route one channel a launch
            if not chans or (min(chans) < 2 if route != "scheme" else set(chans) != {1}):
                raise AssertionError(f"{route} route: decode_plain took {chans} channels")
            walked = "index walk" in REPORTER.stages
            if walked != (route == "walk"):
                raise AssertionError(f"{route} route: the native lens walk "
                                     f"{'ran' if walked else 'did not run'}")
            loader = (f", and on one read in {every} to load_qventry (host per-read "
                      f"loader {t3 - t2:.3f} s for {len(sample)} reads, "
                      f"{int(rl[::every].sum())} symbols/channel)" if sample else "")
            log(f"[db] {db_name} ({route} route, ascii mode {mode}): {got.shape[1]} "
                f"symbols/channel of {db.nreads} reads identical to the .quiva{loader}; "
                f"device {t1 - t0:.3f} s (host clock), stages (s): {_stage_line()}; "
                f"launches {_nonzero(launches)}, twin calls {_nonzero(twins)}, "
                f"decode_plain channels a call {sorted(set(chans))}")
            return launches, twins

        checked = set()
        for name in names:
            res[f"fused {name}"] = load(name, "fused", 1)
        for mode in (0, 1, 2):
            res[f"fused both {mode}"] = load("both", "fused", mode)
        for ext in ("anno", "data"):
            os.remove(os.path.join(d, f".both.qvchk.{ext}"))
        res["walk both 1"] = load("both", "walk", 1)
        for mode in (0, 1, 2):
            res[f"scheme both {mode}"] = load("both", "scheme", mode)
    return res


def _path_launches(path, launches, twins, kernels):
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing or any(twins.values()):
        raise AssertionError(f"{path} path: kernels not launched {missing}, "
                             f"twin calls {twins}")


@contextlib.contextmanager
def _env(**values):
    """Within the block, the environment variables ``values`` are set."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


SHARDS = (1, 2, 4)   # phase 14's meshes on one card
DECODE_ROUTES = {"segmented": {}, "per_read": {"DXT_SEG_DECODE": "0"}}


def phase_multichip(device, quivas, encoded, fasta: bytes, db: str, shards=SHARDS,
                    backend: str = "nccl", timeout: int = 300, spawn: bool = True):
    """The sharded pipeline (parallel/) on one device.  (a) Meshes of
    ``shards`` shards: sharded_scan_to_stats against scan_quiva on each
    .quiva of ``quivas`` [(name, image)]; sharded_qv_encode against
    qv_encode_step on the uniform rectangle (K1/K2) and on the widest
    long-read bucket (K9/K8), and the container assembled from the uniform
    one against the native encoder; decode_dexqv_to_quiva(mesh=) on each
    .dexqv of ``encoded`` [(name, original, image)] through the segmented
    and per-read routes against the original; load_all_qventries(mesh=) of
    the DB ``db`` against the call without a mesh on the fused and
    per-scheme routes; sharded_twobit_encode/decode
    of the .fasta rows of ``fasta`` against one shard.  On the card every
    check launches its kernels and no twin.  (b) A one-rank process group
    of ``backend``: the scan and one decode through its collectives.  (c)
    Two processes of tools/multichip.py over gloo sharing the device, whose
    parts concatenated must be the native encoder's file (unless ``spawn``
    is false).  Returns {shards: kernel launches of the sharded decodes}."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dextractor_tpu_torch.codecs.qv_codec import (
        assemble_from_step, create_qvcoding, decode_dexqv_to_quiva, encode_quiva_to_dexqv,
        scan_quiva)
    from dextractor_tpu_torch.db import open_db
    from dextractor_tpu_torch.formats.fasta import parse_seq_file
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.formats.ragged import pad_rows
    from dextractor_tpu_torch.ops import twobit as tb
    from dextractor_tpu_torch.ops.emit import fused_ok
    from dextractor_tpu_torch.parallel import multihost
    from dextractor_tpu_torch.parallel import pipeline as pl
    from dextractor_tpu_torch.parallel.mesh import make_mesh
    from dextractor_tpu_torch.testing import step_batch, widest_bucket_batch
    from dextractor_tpu_torch.tools.multichip import rect_batch, stats_equal, step_outputs_equal
    from dextractor_tpu_torch.utils import dispatch

    card = on_card(device)
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    decode_launches = {k: dict.fromkeys(DECODE_KERNELS, 0) for k in shards}
    t_phase = time.perf_counter()

    def mlog(msg):
        log(f"[multichip +{time.perf_counter() - t_phase:6.1f}s] {msg}")

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    def run(label, kernels, fn, *args, **kw):
        """fn(*args, **kw) with the counts set to 0 before and read after;
        on the card each of ``kernels`` must launch and no twin run.
        Returns (output, host-clock seconds, launches)."""
        sync()
        dispatch.reset_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        seconds = time.perf_counter() - t0
        launches, twins = _counts()
        if card:
            _path_launches(label, launches, twins, kernels)
        return out, seconds, launches

    def per_shards(label, kernels, check, fn_of_mesh, *args, **kw):
        """``fn_of_mesh(mesh)(*args, **kw)`` on a mesh of each size, each
        output held by ``check``; logs the seconds of each beside one
        shard's and returns {shards: launches}."""
        secs, counts = {}, {}
        for k in shards:
            out, secs[k], counts[k] = run(f"{label}, {k} shards", kernels,
                                          fn_of_mesh(make_mesh(k, dev)), *args, **kw)
            if not check(out):
                raise AssertionError(f"{label}: {k} shards disagree")
        mlog(f"{label}: equal on {list(shards)} shards; host-clock seconds "
            + ", ".join(f"{k} shards {secs[k]:.4f}" for k in shards)
            + f"; launches {_nonzero(counts[shards[-1]])} on {shards[-1]} shards")
        return counts

    # (a) scan
    for name, quiva in quivas:
        q, streams, lengths = rect_batch(quiva)
        host = scan_quiva(q)
        streams_d, lengths_d = (torch.from_numpy(x).to(dev) for x in (streams, lengths))
        per_shards(f"sharded_scan_to_stats {name} ({tuple(streams.shape)})", (),
                   lambda st: stats_equal(st, host),
                   lambda m: lambda *a: pl.sharded_scan_to_stats(m, *a), streams_d, lengths_d)
        del streams_d

    # (a) encode: the uniform rectangle through K1/K2 (and its container
    # against the native encoder's), the widest long-read bucket through
    # K9/K8, K3 on both
    q = parse_quiva(quivas[0][1])
    coding = create_qvcoding(scan_quiva(q), q.prefix, False)
    native = encode_quiva_to_dexqv(quivas[0][1], device=False)

    def container_ok(out):
        return assemble_from_step(out, coding, q.wells, q.begs, q.ends, q.qvs,
                                  q.n_entries) == native

    for name, (args, run_on), whole in (
            (quivas[0][0], step_batch(quivas[0][1]), True),
            (quivas[-1][0] + " widest bucket", widest_bucket_batch(quivas[-1][1]), False)):
        width = args[0].shape[2]
        kernels = (("encode_plain", "encode_run") if fused_ok(width) else
                   ("lut_gather", "pack_words")) + ("pack_tags",)
        d_args = [torch.from_numpy(a).to(dev) for a in args]
        single = pl.qv_encode_step(*d_args, run_on=run_on)
        per_shards(f"sharded_qv_encode {name} (streams {tuple(args[0].shape)}, run_on "
                   f"{run_on}, {'K1/K2' if fused_ok(width) else 'K9/K8'}"
                   f"{', its container equal to the native encoder' if whole else ''})",
                   kernels, lambda o: step_outputs_equal(o, single) and (
                       not whole or container_ok(o)),
                   lambda m: pl.sharded_qv_encode(m, run_on), *d_args)

    # (a) decode, every route
    for name, data, enc in encoded:
        for route, env in DECODE_ROUTES.items():
            with _env(**env):
                counts = per_shards(f"decode_dexqv_to_quiva {name} ({route} route)",
                                    DECODE_KERNELS, lambda got: got == data,
                                    lambda m: lambda e: decode_dexqv_to_quiva(e, mesh=m), enc)
            for k, c in counts.items():
                for kern in DECODE_KERNELS:
                    decode_launches[k][kern] += c[kern]

    # (a) the DB's QV load
    d = open_db(db)
    d.open_qvs()
    for route in ("fused", "scheme"):
        with _env(DXT_DB_FUSED="1" if route == "fused" else "0"):
            want, rl = d.load_all_qventries(1, device=dev)
            per_shards(f"load_all_qventries two-cell DB ({route} route, {d.nreads} reads)",
                       DECODE_KERNELS, lambda got: np.array_equal(got[0], want),
                       lambda m: lambda: d.load_all_qventries(1, mesh=m))

    # (a) the 2-bit codec on the .fasta rows
    seqs = parse_seq_file(fasta).seqs
    rows = pad_rows(seqs.flat, seqs.lengths, align=4)
    rows_d, lens_d = torch.from_numpy(rows).to(dev), torch.from_numpy(seqs.lengths).to(dev)
    packed = pl.sharded_twobit_encode(make_mesh(1, dev))(rows_d, lens_d, tb.NUMBER_BASE_LUT)
    per_shards(f"sharded_twobit_encode .fasta rows {rows.shape}", ("pack2bit",),
               lambda got: torch.equal(got, packed),
               lambda m: pl.sharded_twobit_encode(m), rows_d, lens_d, tb.NUMBER_BASE_LUT)
    letters = pl.sharded_twobit_decode(make_mesh(1, dev))(packed, tb.LOWER_LUT)
    inlen = np.arange(rows.shape[1])[None, :] < seqs.lengths[:, None]
    if not np.array_equal(np.where(inlen, letters.cpu().numpy()[:, :rows.shape[1]], 0),
                          np.where(inlen, tb.LOWER_LUT[tb.NUMBER_BASE_LUT[rows]], 0)):
        raise AssertionError("sharded_twobit_decode does not give the .fasta's letters back")
    per_shards(f"sharded_twobit_decode .fasta rows {tuple(packed.shape)}", ("unpack2bit",),
               lambda got: torch.equal(got, letters),
               lambda m: pl.sharded_twobit_decode(m), packed, tb.LOWER_LUT)

    # (b) a one-rank group: the collectives through ``backend``
    q_name, quiva = quivas[0]
    name, data, enc = encoded[0]
    q, streams, lengths = rect_batch(quiva)
    multihost.init_group(f"127.0.0.1:{_free_port()}", 1, 0, backend)
    try:
        mesh = multihost.process_mesh(shards[-1], dev)
        got_backend = dist.get_backend(mesh.group)
        (stats, secs, _) = run("one-rank group scan", (), pl.sharded_scan_to_stats, mesh,
                               torch.from_numpy(streams).to(dev), lengths)
        got, dsecs, launches = run("one-rank group decode", DECODE_KERNELS,
                                   decode_dexqv_to_quiva, enc, mesh=mesh)
    finally:
        dist.destroy_process_group()
    if got_backend != backend or not stats_equal(stats, scan_quiva(q)) or got != data:
        raise AssertionError(f"one-rank {backend} group: backend {got_backend}, or the "
                             "scan or the decode differs")
    mlog(f"one-rank {backend} group, {shards[-1]} shards on {dev}: "
        f"sharded_scan_to_stats {q_name} equals scan_quiva ({secs:.4f} s), "
        f"decode_dexqv_to_quiva {name} equals the original ({dsecs:.4f} s, launches "
        f"{_nonzero(launches)})")

    # (c) two processes over gloo sharing the device
    if not spawn:
        log(f"[multichip] phase 14: {time.perf_counter() - t_phase:.1f} s wall, "
            "no processes spawned")
        return decode_launches
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, f"{q_name}.quiva")
        with open(src, "wb") as f:
            f.write(quiva)
        coordinator = f"127.0.0.1:{_free_port()}"
        cmd = [sys.executable, "-m", "dextractor_tpu_torch.tools.multichip", "--world", "2",
               "--coordinator", coordinator, "--quiva", src, "--out", tmp,
               "--device", str(dev), "--backend", "gloo"]
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        seconds = time.perf_counter() - t0
        for r, (p, (o, e)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"multichip rank {r} exited {p.returncode}: {e[-3000:]}")
        parts = b"".join(open(os.path.join(tmp, f"part{r}.bin"), "rb").read()
                         for r in range(2))
    if parts != native:
        raise AssertionError("the two processes' parts differ from the native encoder's file")
    mlog(f"two gloo processes on {dev} ({seconds:.1f} s with their start-up): "
         f"parts of {q_name} concatenated equal the native encoder's file; "
         + "; ".join(line for o, _ in outs for line in o.splitlines()
                     if line.startswith("[multichip rank")))
    log(f"[multichip] phase 14: {time.perf_counter() - t_phase:.1f} s wall")
    return decode_launches


SURFACE_KERNELS = ("pack2bit", "unpack2bit", "lut_gather")


@contextlib.contextmanager
def decode_twins():
    """Within the block, the wrappers of K4 and K5 are their twins
    (ops/decode2.plain_chains, run_chain), which run on the tensors' device,
    the card included."""
    from dextractor_tpu_torch.ops import decode2 as d2
    from dextractor_tpu_torch.ops import decode_chains

    saved = decode_chains.decode_plain, decode_chains.decode_run
    decode_chains.decode_plain, decode_chains.decode_run = d2.plain_chains, d2.run_chain
    try:
        yield
    finally:
        decode_chains.decode_plain, decode_chains.decode_run = saved


def v1_batch(dexqv: bytes):
    """The v1 decoders' arguments for the insQV and delQV streams of every
    entry of a .dexqv image, each stream's start from the port's index walk
    (codecs/qv_codec._index_native): {"buf", "ins_starts", "del_starts",
    "rlens", "lookups", "lens_tbl", "types", "ids" {channel: scheme id},
    "coding", "coffs", "ntoks"}.  The tables hold the coding's del, drun
    and ins schemes (drun only when delQV is run-coded)."""
    import numpy as np
    from dextractor_tpu_torch.codecs.qv_codec import _index_native
    from dextractor_tpu_torch.formats import dexqv as dq

    coding, off = dq.parse_qvcoding(memoryview(dexqv), 2)
    _, _, _, _, eoffs, elens, coffs, ntoks = _index_native(dexqv, coding, off, True)
    schemes = {"del": coding.del_scheme, "ins": coding.ins_scheme}
    if coding.del_char >= 0:
        schemes["drun"] = coding.drun_scheme
    for s in schemes.values():
        s.with_lookup()
    eoffs = np.asarray(eoffs, np.int64)
    return {"buf": np.frombuffer(dexqv, np.uint8), "del_starts": eoffs,
            "ins_starts": eoffs + np.asarray(coffs, np.int64)[:, 1],
            "rlens": np.asarray(elens, np.int32),
            "lookups": np.stack([s.lookup for s in schemes.values()]).astype(np.int32),
            "lens_tbl": np.stack([s.codelens for s in schemes.values()]).astype(np.int32),
            "types": np.array([s.type for s in schemes.values()], np.int32),
            "ids": {k: i for i, k in enumerate(schemes)}, "coding": coding,
            "coffs": np.asarray(coffs, np.int64), "ntoks": np.asarray(ntoks)}


def v1_decodes(b, device, mesh=None):
    """insQV through decode_plain_batch and delQV through decode_run_batch
    (decode_plain_batch when delQV is plain) of a ``v1_batch``, on
    ``device``, or over ``mesh`` through sharded_decode_plain/_run:
    {"ins": outputs, "del": outputs}."""
    import numpy as np
    from dextractor_tpu_torch.formats.ragged import bucket_len
    from dextractor_tpu_torch.ops.decode_torch import decode_plain_batch, decode_run_batch
    from dextractor_tpu_torch.parallel import pipeline as pl

    n = len(b["rlens"])
    max_len = bucket_len(int(b["rlens"].max(initial=0)), 512)
    tables = (b["lookups"], b["lens_tbl"], b["types"])

    def plain(starts, sid):
        ids = np.full(n, sid, np.int32)
        if mesh is not None:
            return pl.sharded_decode_plain(mesh, max_len=max_len)(
                b["buf"], starts, b["rlens"], ids, *tables)
        return decode_plain_batch(b["buf"], starts, b["rlens"], ids, *tables,
                                  max_len=max_len, device=device)

    out = {"ins": plain(b["ins_starts"], b["ids"]["ins"])}
    if "drun" not in b["ids"]:
        out["del"] = plain(b["del_starts"], b["ids"]["del"])
        return out
    max_tokens = bucket_len(int(b["ntoks"][:, 0].max(initial=0)), 16)
    ids = (np.full(n, b["ids"]["del"], np.int32), np.full(n, b["ids"]["drun"], np.int32))
    if mesh is not None:
        out["del"] = pl.sharded_decode_run(mesh, max_tokens=max_tokens)(
            b["buf"], b["del_starts"], b["rlens"], *ids, *tables)
    else:
        out["del"] = decode_run_batch(b["buf"], b["del_starts"], b["rlens"], *ids, *tables,
                                      max_tokens=max_tokens, device=device)
    return out


def _same_outputs(a, b):
    import torch

    return all(len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
               for k in a)


def v1_against_per_scheme(b, outs, device):
    """The v1 decodes of ``v1_batch`` ``b`` against the per-scheme route
    (codecs/qv_batch.batch_decode_entries) on the same entries: insQV's
    symbols and delQV's (its tokens expanded on the host by expand_runs_np)
    equal that route's rows within each read, and each stream's word count
    from total_bits and last_gran is its length in the index walk's channel
    offsets."""
    import numpy as np
    from dextractor_tpu_torch.codecs.qv_batch import batch_decode_entries
    from dextractor_tpu_torch.ops.decode2 import stream_word_counts
    from dextractor_tpu_torch.ops.decode_torch import expand_runs_np

    rl = b["rlens"]
    rows, _ = batch_decode_entries(b["buf"], b["del_starts"], rl, [b["coding"]],
                                   np.zeros(len(rl), np.int64), device=device)
    inr = np.arange(rows.shape[2])[None, :] < rl[:, None]
    ins, dl = ([x.cpu().numpy() for x in outs[k]] for k in ("ins", "del"))
    del_rows = (expand_runs_np(dl[0], dl[1], rl, b["coding"].del_char)
                if "drun" in b["ids"] else dl[0])
    w = min(rows.shape[2], ins[0].shape[1], del_rows.shape[1])
    inr = inr[:, :w]
    for name, got, chan in (("insQV", ins[0], 2), ("delQV", del_rows, 0)):
        if not np.array_equal(np.where(inr, got[:, :w], 0), np.where(inr, rows[chan, :, :w], 0)):
            raise AssertionError(f"v1 {name} differs from the per-scheme route's rows")
    spans = {"insQV": (ins, b["coffs"][:, 2] - b["coffs"][:, 1]),
             "delQV": (dl, b["coffs"][:, 0])}
    for name, (o, nbytes) in spans.items():
        if not np.array_equal(4 * stream_word_counts(o[-2], o[-1]), nbytes):
            raise AssertionError(f"v1 {name}: word counts differ from the index walk")


def phase_v1_surface(device, encoded, fasta: bytes, uniform: bytes, long: bytes,
                     shards=SHARDS):
    """The v1 decoders and the JAX package's public surface on ``device``.

    (a) decode_plain_batch on insQV and decode_run_batch on delQV of each
    .dexqv of ``encoded`` [(name, image)], the streams' starts from the
    index walk: K4b and K5 launched and no twin; each against the
    per-scheme route (``v1_against_per_scheme``), the first also against
    the twins on the same device (``decode_twins``); sharded_decode_plain/
    _run on meshes of ``shards`` shards equal to the one-device result.
    (b) The 2-bit device ops on the .fasta rows of ``fasta``:
    pack_translate, translate, pack_2bit, unpack_translate and unpack_2bit,
    K7, K9 and the unpack launched and no twin, each equal to its twin and
    the round trip to the rows' letters.  (c) tools/step_verify on
    ``uniform`` (its STEPV line, step_bytes_ok true) and tools/encode_split
    on ``uniform`` and ``long`` (its SPLIT line; on the CPU both are
    rehearsals of their control flow).  Returns {(a) or (b): launch counts}."""
    import numpy as np
    import torch
    from dextractor_tpu_torch.formats.fasta import parse_seq_file
    from dextractor_tpu_torch.formats.ragged import pad_rows
    from dextractor_tpu_torch.ops import twobit as tb
    from dextractor_tpu_torch.parallel.mesh import make_mesh
    from dextractor_tpu_torch.tools import encode_split, step_verify
    from dextractor_tpu_torch.utils import dispatch

    card = on_card(device)
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    t_phase = time.perf_counter()
    counts = {}

    def vlog(msg):
        log(f"[v1 +{time.perf_counter() - t_phase:6.1f}s] {msg}")

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    def main_path(label, kernels, fn):
        """fn() with the counts set to 0 before and read after; on the card
        each of ``kernels`` must launch and no twin run."""
        sync()
        dispatch.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        seconds = time.perf_counter() - t0
        launches, twins = _counts()
        if card:
            _path_launches(label, launches, twins, kernels)
        counts[label] = _nonzero(launches) if card else _nonzero(twins)
        return out, seconds

    # (a) the v1 decoders
    for i, (name, dexqv) in enumerate(encoded):
        b = v1_batch(dexqv)
        kernels = ("decode_plain",) + (("decode_run",) if "drun" in b["ids"] else ())
        outs, secs = main_path(f"v1 decoders {name}", kernels, lambda: v1_decodes(b, dev))
        v1_against_per_scheme(b, outs, dev)
        checks = "the per-scheme route's rows and the index walk's stream lengths"
        if i == 0:
            with decode_twins():
                twins = v1_decodes(b, dev)
            if not _same_outputs(outs, twins):
                raise AssertionError(f"v1 decoders {name}: the kernels differ from the twins")
            checks += ", the twins on the same device"
        for k in shards:
            if not _same_outputs(v1_decodes(b, dev, make_mesh(k, dev)), outs):
                raise AssertionError(f"sharded v1 decoders {name}: {k} shards differ "
                                     "from one device")
        vlog(f"v1 decoders {name} ({len(b['rlens'])} reads, delQV "
             f"{'RLE' if 'drun' in b['ids'] else 'plain'}): {secs:.4f} s host clock for "
             f"both; launches {counts[f'v1 decoders {name}']}; equal to {checks}; "
             f"sharded_decode_plain/_run on {list(shards)} shards equal to one device")

    # (b) the 2-bit device ops
    seqs = parse_seq_file(fasta).seqs
    rows = torch.from_numpy(pad_rows(seqs.flat, seqs.lengths, align=4)).to(dev)
    lens = torch.from_numpy(seqs.lengths).to(dev)

    def ops():
        packed = tb.pack_translate(rows, lens, "base")
        codes = tb.translate(rows, tb.NUMBER_BASE_LUT)
        return (packed, codes, tb.pack_2bit(codes, lens), tb.unpack_translate(packed, tb.LOWER_LUT),
                tb.unpack_2bit(packed))

    (packed, codes, packed2, letters, codes2), secs = main_path(
        "2-bit ops", SURFACE_KERNELS, ops)
    base = torch.from_numpy(tb.NUMBER_BASE_LUT).to(dev)
    identity = torch.arange(256, device=dev).to(torch.uint8) & 3
    lower = torch.from_numpy(tb.LOWER_LUT).to(dev)
    twins = {"pack_translate": (packed, tb.pack2bit_twin(rows, lens, base)),
             "translate": (codes, base[rows.long()]),
             "pack_2bit": (packed2, tb.pack2bit_twin(codes, lens, identity)),
             "unpack_translate": (letters, tb.unpack2bit_twin(packed, None, lower)),
             "unpack_2bit": (codes2, tb.unpack2bit_twin(packed, None, identity[:4]))}
    bad = [k for k, (got, want) in twins.items() if not torch.equal(got, want)]
    inlen = torch.arange(rows.shape[1], device=dev)[None, :] < lens.long()[:, None]
    if bad or not torch.equal(packed, packed2) or not torch.equal(
            torch.where(inlen, letters[:, :rows.shape[1]], 0),
            torch.where(inlen, lower[codes.long()], 0)):
        raise AssertionError(f"2-bit ops: {bad or 'the round trip'} differ")
    vlog(f"2-bit ops on the .fasta rows {tuple(rows.shape)}: {secs:.4f} s host clock; "
         f"launches {counts['2-bit ops']}; each equal to its twin, pack_2bit(translate) to "
         "pack_translate, the unpacked letters to the rows'")

    # (c) the encode step's tools
    res = step_verify.verify(uniform, dev)
    log("STEPV: " + json.dumps(res))
    if not res["step_bytes_ok"]:
        raise AssertionError("step_verify: the encode step's bytes differ from the native "
                             "encoder's")
    log("SPLIT: " + json.dumps(encode_split.split(uniform, long, dev)))
    log(f"[v1] phase 15: {time.perf_counter() - t_phase:.1f} s wall")
    return counts


class RunRecord:
    """The record that ``--out FILE`` writes: the UTC time of the start,
    ``git rev-parse HEAD`` of the checkout chip_smoke.py lies at the root of
    (None outside one), the card's name and power limit as nvidia-smi gives
    them, each phase's name, ok and wall seconds, and the kernels line.  It
    is written at the end, and when a phase fails (that phase with ok
    false).  Without a path it only keeps the phases."""

    def __init__(self, path: str | None):
        import datetime

        self.path = path
        self.data = {"utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
                     "git_head": _git_head(), "card": None, "phases": [], "kernels": None,
                     "ok": False}

    @contextlib.contextmanager
    def phase(self, name: str):
        entry = {"name": name, "ok": False, "seconds": None}
        self.data["phases"].append(entry)
        t0 = time.perf_counter()
        try:
            yield
            entry["ok"] = True
        finally:
            entry["seconds"] = time.perf_counter() - t0
            if not entry["ok"]:
                self.write()

    def write(self):
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self.data, f, indent=1)
                f.write("\n")


def _git_head():
    """HEAD of the git checkout whose root holds this script, or None."""
    try:
        top = subprocess.run(["git", "-C", REPO, "rev-parse", "--show-toplevel", "HEAD"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = top.stdout.split()
    if top.returncode or len(lines) != 2 or os.path.realpath(lines[0]) != os.path.realpath(REPO):
        return None
    return lines[1]


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="Smoke test of the port on one GPU.")
    p.add_argument("--out", default=None,
                   help="write a JSON record of the run (phases, card, kernels) to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from dextractor_tpu_torch.testing import long_quiva, uniform_quiva

    rec = RunRecord(args.out)
    phase = rec.phase
    t_start = time.perf_counter()
    with phase("1 environment"):
        rec.data["card"] = phase_environment()
    with phase("2 build"):
        phase_build()
    uniform, long = uniform_quiva(), long_quiva()
    with phase("3 encode kernels"):
        res = phase_encode_kernels("cuda", uniform, long)
    with phase("4 encode slice"):
        launches, twins, encoded = phase_encode_slice(True, corpora(uniform, long))
        _path_launches("encode", launches, twins, ENCODE_KERNELS)
    with phase("5 encode step"):
        phase_encode_step("cuda", uniform, long)
    with phase("6 decode kernels"):
        res.update(phase_decode_kernels("cuda", encoded))
    with phase("7 decode slice"):
        p_launches, p_twins = phase_decode_slice(True, encoded, segmented=False)
        _path_launches("decode (per-read route)", p_launches, p_twins, DECODE_KERNELS)
        d_launches, d_twins = phase_decode_slice(True, encoded)
        _path_launches("decode", d_launches, d_twins, DECODE_KERNELS)
        launches.update({k: d_launches[k] for k in DECODE_KERNELS})
    with phase("8 decode step"):
        phase_decode_step("cuda", encoded[0][3])
        phase_decode_long("cuda", encoded[-1][3])
    tcases = twobit_corpora()
    with phase("9 2-bit kernels"):
        res.update(phase_twobit_kernels("cuda", tcases))
    with phase("10 2-bit slice"):
        t_launches, t_twins = phase_twobit_slice(True, tcases)
        _path_launches("2-bit", t_launches, t_twins, TWOBIT_KERNELS)
        launches.update({k: t_launches[k] for k in TWOBIT_KERNELS})
    with phase("11 tag kernel"):
        res.update(phase_tag_kernel("cuda", encoded))
    with phase("12 decode phase split"):
        a_launches, a_twins = phase_decode_ablate("cuda")
        _path_launches("decode phase split", a_launches, a_twins, ("tag_route",))
        launches["tag_route"] = a_launches["tag_route"]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_db_")
    try:
        with phase("13 Dazzler DB"):
            for route, (l_, t_) in phase_db(True, db_corpora(), workdir=workdir).items():
                _path_launches(f"DB QV load ({route})", l_, t_, DECODE_KERNELS)
        with phase("14 sharded pipeline"):
            decode_counts = phase_multichip(
                "cuda", [("uniform", uniform), ("long_reads", long)],
                [(encoded[i][0], encoded[i][1], encoded[i][3]) for i in (0, -1)],
                tcases[0][1], os.path.join(workdir, "both"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("[multichip] decode kernel launches a shard count (both .dexqv, both routes): "
        + json.dumps({str(k): v for k, v in decode_counts.items()}))
    with phase("15 v1 decoders and the surface"):
        v1_counts = phase_v1_surface("cuda", [(encoded[i][0], encoded[i][3]) for i in (0, -1)],
                                     tcases[0][1], uniform, long)
    log("[v1] kernel launches a path: " + json.dumps(v1_counts))
    bad = [m for m in sys.modules if m in ("jax", "dextractor_tpu")
           or m.startswith(("jax.", "dextractor_tpu."))]
    if bad:
        raise AssertionError(f"imported {bad}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **res[name]}
        for name, (src, rep) in KERNELS.items()]}
    rec.data.update(kernels=kernels["kernels"], ok=True, seconds=time.perf_counter() - t_start)
    rec.write()
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
