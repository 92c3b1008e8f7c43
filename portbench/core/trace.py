"""Spans, the device trace, and what a traced run reads from them.

A traced run (``--trace 1``) records, over its traced part:

- the program's own stage spans (``utils.profiling.stage``): the run puts a
  ``SpanRecorder`` in the place of the program's ``REPORTER``, which sums
  each stage's host-clock seconds and marks it in the profiler's timeline;
- the harness's span around each call (``call``);
- a ``torch.profiler`` trace of the CPU and the card, exported as a
  Chrome trace into ``$TMPDIR``, read, and deleted.

``analyse`` reduces the trace to: the traced window's length, the seconds
in which some operation ran on the card (the union of kernels, copies and
sets), device seconds by operation name, the seconds of the program's own
kernels, and the idle seconds of the card by the innermost host stage that
was open then (``_no_stage_`` inside a call but in no stage,
``_between_calls_`` outside every call).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench:window"
STAGE = "stage:"
CALL = "call"


def own_kernel_names(program_dir: str) -> list[str]:
    """The ``__global__`` functions of the program's CUDA sources: the
    kernels it wrote itself."""
    names = set()
    for path in sorted(glob.glob(os.path.join(program_dir, "ops", "csrc", "*.cu"))):
        with open(path) as f:
            src = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*[(<]", src))
    return sorted(names)


class SpanRecorder:
    """Takes the place of the program's ``profiling.REPORTER`` in a traced
    part: sums each stage's host-clock seconds and opens a profiler range
    ``stage:<name>`` around it."""

    enabled = True

    def __init__(self, record_function):
        self.record_function = record_function
        self.seconds = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        with self.record_function(STAGE + name):
            yield
        self.seconds[name] += time.perf_counter() - t0


class Tracer:
    """Profiler, span recorder and call spans over one traced part."""

    def __init__(self, profiling_module):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._profile = profile
        self._acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            self._acts.append(ProfilerActivity.CUDA)
        self._rf = record_function
        self._mod = profiling_module
        self.recorder = SpanRecorder(record_function)
        self.active = False
        self.trace = None

    def call_span(self):
        return self._rf(STAGE + CALL) if self.active else contextlib.nullcontext()

    def start(self) -> None:
        self._saved = self._mod.REPORTER
        self._mod.REPORTER = self.recorder
        self.prof = self._profile(activities=self._acts)
        self.prof.start()
        self._mark = self._rf(WINDOW)
        self._mark.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.seconds = time.perf_counter() - self.t0
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self._mod.REPORTER = self._saved
        self.active = False
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _stage_segments(spans, w0: float, w1: float):
    """Disjoint (start, end, label) pieces of [w0, w1], each labelled by the
    innermost span open over it; spans nest, as the ``with`` blocks that
    made them do."""
    edges = []
    for a, b, name in spans:
        edges.append((max(a, w0), 1, b - a, name))
        edges.append((min(b, w1), 0, b - a, name))
    edges.sort(key=lambda e: (e[0], e[1], -e[2] if e[1] else e[2]))
    stack, segs, t = [], [], w0
    for x, opening, _, name in edges:
        if x > t:
            segs.append((t, x, stack[-1] if stack else None))
            t = x
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if w1 > t:
        segs.append((t, w1, stack[-1] if stack else None))
    return segs


def _label(name):
    if name is None:
        return "_between_calls_"
    return "_no_stage_" if name == CALL else name


def analyse(trace: dict, own: list[str]) -> dict:
    """The traced part's device time, idle time by host stage, and device
    time by operation.  Times in seconds."""
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], []
    by_name = defaultdict(float)
    own_re = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, own))) if own else None
    own_us = launches = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[e["name"]] += b - a
            if cat == "kernel" and own_re is not None and own_re.search(e["name"]):
                own_us += b - a
                launches += 1
        elif (cat == "user_annotation" and e.get("name", "").startswith(STAGE)
              and b > w0 and a < w1):
            spans.append((a, b, e["name"][len(STAGE):]))
    busy = _union(dev)
    idle = []
    t = w0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle.append((t, w1))
    gaps = defaultdict(float)
    segs = _stage_segments(spans, w0, w1)
    j = 0
    for a, b in idle:                    # both lists are sorted and disjoint
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            gaps[_label(name)] += min(b, s1) - max(a, s0)
            k += 1
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": sum(b - a for a, b in busy) * us,
        "device_s": sum(by_name.values()) * us,
        "own_s": own_us * us,
        "own_launches": int(launches),
        "ops": {k: v * us for k, v in by_name.items()},
        "idle_gaps": {k: v * us for k, v in gaps.items()},
    }


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def breakdown(a: dict) -> dict:
    """The ten device operations that took most time, and the ten largest
    idle shares by host stage."""
    def top(d):
        return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(a["ops"]), "idle_gaps": top(a["idle_gaps"])}
