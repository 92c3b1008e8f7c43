"""One run of one cell: set-up, the measured window, the check, the readings.

The window is a closed loop of one caller: call after call (whole files,
or steps enqueued ahead) until ``seconds`` have passed, then one
synchronisation; everything completed counts, over all the time.  The
collector is frozen and off inside it.  A traced run profiles the window,
or its first ``trace_seconds`` where the traffic file says so; the
end-to-end metrics come only from runs without the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

from . import kinds, registry
from .trace import Tracer, analyse, breakdown, own_kernel_names


def _window(kind, seconds: float, tracer, trace_seconds, launches: dict) -> dict:
    gc.collect()
    gc.freeze()
    gc.disable()
    before = dict(launches)
    host, traced = [], []
    payload = calls = 0
    t_traced = None
    try:
        if tracer is not None:
            kind.sync()
            tracer.start()
            at_start = dict(launches)
        t0 = time.perf_counter()
        while True:
            tc = time.perf_counter()
            with tracer.call_span() if tracer is not None else contextlib.nullcontext():
                payload += kind.call(calls)
            t1 = time.perf_counter()
            host.append(t1 - tc)
            if tracer is not None and tracer.active:
                traced.append(calls)
            calls += 1
            if (tracer is not None and tracer.active and trace_seconds
                    and t1 - t0 >= trace_seconds):
                kind.sync()
                t_traced = {k: launches[k] - at_start[k] for k in launches}
                tracer.stop()
            if t1 - t0 >= seconds:
                break
        kind.sync()
        t_end = time.perf_counter()
        if tracer is not None and tracer.active:
            t_traced = {k: launches[k] - at_start[k] for k in launches}
            tracer.stop()
    finally:
        gc.enable()
    return dict(window_s=t_end - t0, payload_bytes=payload, calls=calls, host_s=host,
                traced=traced, launches={k: launches[k] - before[k] for k in launches},
                launches_traced=t_traced)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", root: str = registry.ROOT, lossy: bool = False,
             config: dict | None = None, log=print) -> tuple[dict, dict]:
    """Run one cell; returns (the result line's object, the checks)."""
    import torch
    from dextractor_tpu_torch.utils import dispatch, profiling

    bench = registry.load(root)
    cell = registry.cell(bench, workload)
    cfg = config if config is not None else registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    dev = torch.device(device)
    kind = kinds.KINDS[traffic["kind"]](cfg, traffic, seed, dev, lossy, log)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"portbench: set-up: imports and the card {time.perf_counter() - t_start:.3f} s")
    kind.setup()
    # the reference's encodes of a decode cell's inputs are the benchmark's
    # own work, and not the program's: set-up leaves them out
    setup_s = time.perf_counter() - t_start - kind.reference_s

    tracer = Tracer(profiling) if trace else None
    w = _window(kind, seconds, tracer, traffic.get("trace_seconds"), dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    host = sorted(w["host_s"])
    log(f"portbench: window {w['window_s']:.3f} s, {w['calls']} calls "
        f"({kind.unit}s; host s a call min {host[0]:.4f} median {host[len(host) // 2]:.4f} "
        f"max {host[-1]:.4f}), setup {setup_s:.3f} s (and the reference's "
        f"{kind.reference_s:.3f} s apart), twin calls "
        f"{sum(dispatch.TWIN_CALLS.values())}")

    checks = kind.check()
    ctx = dict(w, setup_s=setup_s, spans=None, trace=None, traced_window_s=None,
               work_bytes_traced=None, peak_bytes_per_s=None)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": w["calls"], "failed": kind.failed}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if tracer is not None:
        from .peaks import peak_bytes_per_s
        own = own_kernel_names(os.path.dirname(os.path.dirname(os.path.abspath(dispatch.__file__))))
        a = analyse(tracer.trace, own)
        ctx.update(spans=dict(tracer.recorder.seconds), trace=a,
                   traced_window_s=tracer.seconds,
                   peak_bytes_per_s=peak_bytes_per_s(dev_info["kind"]))
        if kind.unit == "step":
            ctx["work_bytes_traced"] = sum(kind.work_bytes(i) for i in w["traced"])
        counted = sum(w["launches_traced"].values())
        log(f"portbench: traced {a.get('window_s', 0):.3f} s, {len(w['traced'])} calls; "
            f"the trace kept {a.get('own_launches', 0)} of {counted} launches of the "
            f"program's kernels")
        dev_info.update(busy_s=a.get("busy_s", 0.0), window_s=a.get("window_s", 0.0))
    metrics = {}
    for m in registry.metrics(bench, workload, trace):
        v = registry.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev_info
    if tracer is not None and ctx["trace"]:
        result["breakdown"] = breakdown(ctx["trace"])
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks
