"""Per-stage wall time for the CLI's ``-v`` table.

``stage(name, nbytes)`` records into the JAX package's ``REPORTER``, which
``dextractor_tpu.cli._common.codec_tool`` enables, resets and prints; unlike
``REPORTER.stage`` it opens no ``jax.profiler`` annotation, so the port
never imports JAX.  Device work inside a stage is counted because every
stage ends by copying its results to the host.
"""

from __future__ import annotations

import contextlib
import time

from dextractor_tpu.utils.profiling import REPORTER, StageStat


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0):
    if not REPORTER.enabled:
        yield
        return
    t0 = time.perf_counter()
    yield
    st = REPORTER.stages.setdefault(name, StageStat(name))
    st.seconds += time.perf_counter() - t0
    st.nbytes += nbytes
    st.calls += 1
