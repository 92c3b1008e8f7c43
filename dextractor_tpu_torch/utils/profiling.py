"""Per-stage wall time for the CLI's ``-v`` table and ``chip_smoke.py``,
and a profiler trace of a block of code.

The port's own copy of ``dextractor_tpu/utils/profiling.py``'s
``StageStat``/``Reporter``/``REPORTER``, without its ``jax.profiler``
annotation.  ``stage(name, nbytes)`` records into the port's ``REPORTER``,
which ``cli._common.codec_tool`` enables, resets and prints.  Device work
inside a stage is counted because every stage ends by copying its results
to the host.  ``trace_to(logdir)`` is the counterpart of the JAX package's
``jax.profiler`` trace: a ``torch.profiler`` trace of the CPU and, where
there is one, the card, written as one Chrome-trace JSON file that
Perfetto (ui.perfetto.dev) opens; it costs what the profiler costs, so no
hot path uses it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class StageStat:
    name: str
    seconds: float = 0.0
    nbytes: int = 0
    calls: int = 0

    @property
    def gbps(self) -> float:
        return self.nbytes / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class Reporter:
    stages: dict = field(default_factory=dict)
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        st = self.stages.setdefault(name, StageStat(name))
        st.seconds += time.perf_counter() - t0
        st.nbytes += nbytes
        st.calls += 1

    def report(self, out=None) -> None:
        if not self.stages:
            return
        if out is None:          # bind at call time (redirect_stderr)
            out = sys.stderr
        width = max(len(s) for s in self.stages) + 2
        out.write(f"{'stage':<{width}}{'calls':>6}{'secs':>10}{'GB/s':>10}\n")
        for st in self.stages.values():
            gb = f"{st.gbps:.2f}" if st.nbytes else "-"
            out.write(f"{st.name:<{width}}{st.calls:>6}{st.seconds:>10.3f}{gb:>10}\n")


REPORTER = Reporter(enabled=False)


def stage(name: str, nbytes: int = 0):
    return REPORTER.stage(name, nbytes)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Record a torch.profiler trace of the block (CPU activity, and CUDA
    activity when a card is present) into one Chrome-trace JSON file in
    ``logdir``, created if absent.  Yields the profiler; its file is
    ``trace-<pid>-<ns>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
