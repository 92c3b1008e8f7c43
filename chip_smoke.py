#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the .dexqv encode path.

Run from the repository root on a machine with an sm_90 card:

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the final JSON line:

1. environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and nvcc versions; the card must have compute capability (9, 0);
2. build: compile ops/csrc/*.cu with nvcc for sm_90a, timed;
3. kernels: K1 (encode_plain), K2 (encode_run) and K3 (pack_tags) on the
   card against their plain PyTorch twins, bit for bit, at the shapes of the
   16 MB uniform batch and on rows of up to 70,000 symbols with runs over
   255 and over 65,535; the time of kernel and twin per call, both as
   stream time (CUDA events) and as device time (torch.profiler);
4. slice: encode_quiva_to_dexqv(device=True) on four corpora (the uniform
   batch, a sub-heavy corpus, the same lossy, the log-normal long-read
   batch), each byte for byte against the native C encoder
   (device=False); every kernel must have been launched in this phase and
   no twin called;
5. step: median stream time of qv_encode_step on the uniform batch, and
   the share of it the card was busy.

It prints the kernels as one JSON line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the exit code is non-zero and no result is printed.
It exits 1 at once when torch.cuda.is_available() is False.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

KERNELS = {   # wrapper name -> the TPU kernel it replaces
    "encode_plain": "dextractor_tpu/ops/emit_pallas.py:623",
    "encode_run": "dextractor_tpu/ops/emit_pallas.py:662",
    "pack_tags": "dextractor_tpu/ops/emit_pallas.py:551",
}
SOURCE = "dextractor_tpu_torch/ops/csrc/emit.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Median over ``rounds`` of the device time per call of fn(), in ms,
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


def device_ms(fn, reps: int = 20):
    """Device time per call of fn() in ms: the summed durations of the
    kernels and copies it ran on the card, from a torch.profiler (CUPTI)
    trace of ``reps`` calls, and the number of device operations per call.
    Unlike cuda_ms it excludes the gaps in which the card waited for the
    host to enqueue work.  None when the trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1000, len(ev) / reps


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
    log(smi.splitlines()[0])
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc {m.group(1) if m else '?'} capability {cap} "
        f"devices {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, the kernels need (9, 0)")


def phase_build():
    from dextractor_tpu_torch.ops import _build
    from dextractor_tpu_torch.utils import dispatch

    _, seconds, out = _build.build(force=True)
    dispatch.kernels()
    for line in out.splitlines():
        if "Used" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    log(f"[build] nvcc sm_90a {seconds:.2f} s")


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


def wide_rows(rchar: int, seed: int = 11):
    """Rows of up to 70,000 symbols: one all-rchar row (a trailing run over
    65,535), sparse literals (runs over 255), a run of 66,000 before a
    literal, dense random rows, an empty row and a one-symbol row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, l = 8, 70_000
    d = np.full((n, l), rchar, np.uint8)
    d[1, ::300] = 40
    d[2] = rng.integers(33, 63, l)
    d[3, 66_000] = 41
    d[4] = np.where(rng.random(l) < 0.3, rng.integers(33, 63, l), rchar)
    d[5] = rng.integers(0, 256, l)
    d[7] = np.where(rng.random(l) < 0.01, rng.integers(33, 63, l), rchar)
    lengths = np.array([70_000, 70_000, 60_000, 70_000, 70_000, 12_345, 1, 0],
                       np.int32)
    tags = rng.choice(np.frombuffer(b"acgtn", np.uint8), size=(n, l))
    return d, lengths, tags


def concentrated_luts():
    """A skewed scheme with escapes (type 2) as a packed LUT."""
    import numpy as np
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops.huffman import make_scheme

    # geometric counts give a Huffman tree deeper than 16: type 2
    hist = np.ones(256, np.int64)
    hist[:40] += (1.6 ** np.arange(40)).astype(np.int64)
    scheme = make_scheme(hist)
    if scheme.type != 2:
        raise AssertionError("the concentrated scheme has no escapes")
    return bt.scheme_luts(scheme)


def phase_kernels(uniform: bytes):
    """K1-K3 against their twins on the card; returns per-kernel
    {max_abs_err, ms, plain_ms, event_ms, plain_event_ms} at the uniform
    batch's step shapes: ``ms``/``plain_ms`` are device time per call from
    the profiler (it raises when the profiler records none),
    ``event_ms``/``plain_event_ms`` stream time from CUDA events."""
    import numpy as np
    import torch
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.parallel.pipeline import _pack_tags
    from dextractor_tpu_torch.testing import step_batch

    (streams, lengths, sym, run, rchars, nlut), run_on = step_batch(uniform)
    dev = torch.device("cuda")
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
    cases = {
        "encode_plain": (emit.encode_plain, bt.encode_plain_ref, p_in, _check_words),
        "encode_run": (emit.encode_run, bt.encode_run_ref, r_in, _check_words),
        "pack_tags": (emit.pack_tags, _pack_tags, t_in,
                      lambda _n, g, r: _check_tags(g, r)),
    }
    res = {}
    shape = tuple(streams.shape)
    for name, (kern, twin, args, check) in cases.items():
        err = check(name, kern(*args), twin(*args))
        torch.cuda.synchronize()
        event_ms = cuda_ms(lambda: kern(*args))
        plain_event_ms = cuda_ms(lambda: twin(*args), reps=3, warmup=1)
        ms, _ = device_ms(lambda: kern(*args))
        plain_ms, n_ops = device_ms(lambda: twin(*args), reps=3)
        if ms is None or plain_ms is None:
            raise RuntimeError(f"{name}: the profiler recorded no device time")
        log(f"[kernel] {name}: device time (profiler) kernel {ms} ms, twin "
            f"{plain_ms} ms in {n_ops} device ops; stream time (CUDA events) "
            f"kernel {event_ms} ms, twin {plain_event_ms} ms")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "event_ms": event_ms, "plain_event_ms": plain_event_ms}
        log(f"[kernel] {name} streams {shape} bit-identical to twin")

    d, wl, tags = wide_rows(int(rchars[0]) if rchars[0] >= 0 else 102)
    dd = torch.from_numpy(d).to(dev)
    wld = torch.from_numpy(wl).to(dev)
    conc = torch.from_numpy(concentrated_luts()).to(dev)[None]
    p_w = (dd[None], wld, conc)
    r_w = (dd[None], wld, sym_d[0:1].contiguous(), run_d[0:1].contiguous(),
           rch[0:1].contiguous())
    t_w = (torch.from_numpy(tags).to(dev), dd, wld, rch[0:1].contiguous(), nl)
    for name, args in (("encode_plain", p_w), ("encode_run", r_w),
                       ("pack_tags", t_w)):
        kern, twin, _, check = cases[name]
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       check(name, kern(*args), twin(*args)))
    log(f"[kernel] wide rows {tuple(d.shape)} (runs > 255 and > 65,535, "
        "type-2 escapes): K1, K2, K3 bit-identical to their twins")
    return res


def corpora(uniform: bytes):
    import numpy as np
    from dextractor_tpu_torch.testing import long_quiva, make_quiva

    sub_heavy = make_quiva(np.random.default_rng(7), n_reads=120,
                           min_len=1900, max_len=2100, sub_heavy=True)
    return [("uniform", uniform, False), ("sub_heavy", sub_heavy, False),
            ("sub_heavy_lossy", sub_heavy, True), ("long_reads", long_quiva(), False)]


def phase_slice(device, cases):
    """The codec end to end on ``device`` against the native C encoder;
    returns the kernel launch counts of this phase."""
    from dextractor_tpu_torch.codecs.qv_codec import (create_qvcoding,
                                                      encode_quiva_to_dexqv, qv,
                                                      scan_quiva)
    from dextractor_tpu_torch.utils import dispatch
    from dextractor_tpu_torch.utils.profiling import REPORTER

    dispatch.reset_counts()
    for name, data, lossy in cases:
        q = qv.parse_quiva(data)
        coding = create_qvcoding(scan_quiva(q), q.prefix, lossy)
        if name.startswith("sub_heavy") and (coding.drun_scheme is None
                                             or coding.srun_scheme is None):
            raise AssertionError(f"{name}: delQV and subQV must both be RLE")
        REPORTER.stages.clear()
        REPORTER.enabled = True
        t0 = time.perf_counter()
        got = encode_quiva_to_dexqv(data, lossy=lossy, device=device)
        t1 = time.perf_counter()
        REPORTER.enabled = False
        stages = ", ".join(f"{st.name} {st.seconds:.4f}"
                           for st in REPORTER.stages.values())
        ref = encode_quiva_to_dexqv(data, lossy=lossy, device=False)
        t2 = time.perf_counter()
        if got != ref:
            raise AssertionError(f"{name}: device bytes differ from the native encoder")
        log(f"[slice] {name}: {q.n_entries} reads, {int(q.lengths.sum())} "
            f"symbols/channel, max read {int(q.lengths.max())}, "
            f"{len(got)} bytes identical to native; device {t1 - t0:.3f} s, "
            f"native {t2 - t1:.3f} s (host clock); device stages (s): {stages}")
    launches = dict(dispatch.LAUNCHES)
    twins = dict(dispatch.TWIN_CALLS)
    log(f"[slice] launches {launches} twin calls {twins}")
    return launches, twins


def phase_step(device, uniform: bytes):
    import torch
    from dextractor_tpu_torch.parallel.pipeline import qv_encode_step
    from dextractor_tpu_torch.testing import step_batch

    args, run_on = step_batch(uniform)
    dargs = [torch.from_numpy(a).to(device) for a in args]
    payload = 5 * int(args[1].sum())
    out = qv_encode_step(*dargs, run_on=run_on)
    if out[0].device.type != "cuda":
        raise AssertionError("the step did not run on the card")
    ms = cuda_ms(lambda: qv_encode_step(*dargs, run_on=run_on))
    busy, n_ops = device_ms(lambda: qv_encode_step(*dargs, run_on=run_on))
    share = "not measured" if busy is None else f"{busy / ms:.3f}"
    log(f"[step] qv_encode_step streams {tuple(args[0].shape)} run_on {run_on}: "
        f"{ms} ms median (CUDA events), {payload / ms / 1e6} GB/s of "
        f"{payload} payload bytes; device busy {busy} ms in {n_ops} device "
        f"ops (profiler), busy share {share}")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from dextractor_tpu_torch.testing import uniform_quiva

    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    uniform = uniform_quiva()
    res = phase_kernels(uniform)
    launches, twins = phase_slice(True, corpora(uniform))
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing or any(twins.values()):
        raise AssertionError(f"main path: kernels not launched {missing}, "
                             f"twin calls {twins}")
    phase_step("cuda", uniform)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": rep,
         "launches": launches[name], **res[name]}
        for name, rep in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
