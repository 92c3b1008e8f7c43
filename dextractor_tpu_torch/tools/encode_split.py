"""Per-launch attribution of the encode step (the port's counterpart of the
JAX package's ``tools/encode_split.py``): each real sub-call of
``parallel.pipeline.qv_encode_step``, timed alone with the inputs the step
gave it, beside the whole step.

Two batches, the benchmark's shapes (``--mb``, 16 by default):

  uniform  the uniform batch as ``testing.step_batch`` builds it (rows
           padded by ``pad_rows(align=512, bucket=True)``, the row count by
           ``bucket_rows``, the real ``run_on``): K1 (``emit.encode_plain``),
           K2 (``emit.encode_run``) and K3 (``emit.pack_tags``);
  widest   the widest bucket of the long-read batch's device encode
           (``testing.widest_bucket_batch``), which the step sends down the
           emission route: K9 (``lut.lut_gather_groups``), K8
           (``lut.pack_words``), K3, and the emission planes in plain
           PyTorch (``bitstream_torch.plain_emissions``, ``run_setup``,
           ``run_assemble``).

The step runs once with each of those functions wrapped to record its
arguments; then every recorded call is replayed alone, and the step whole.
Each call allocates and writes its outputs as in the step (PyTorch runs
eagerly, so nothing of it is skipped).  On the card a time is the stream
time per call from CUDA events (``chip_smoke.cuda_ms``: the median of 5
rounds of 20 calls after 3 warm-up calls) and the device time per call
from a torch.profiler trace (``chip_smoke.device_ms``, warm: the summed
durations of the call's kernels and copies), with the device operations
per call; ``glue`` is the step's time less the sum over its sub-calls.  On
the CPU (``--device cpu``) each time is its one call on the host clock,
which checks the control flow and is no device time.

Run from the repository root (the card's timers are ``chip_smoke.py``'s):
    python -m dextractor_tpu_torch.tools.encode_split [--mb 16] [--device cuda|cpu]
Prints one ``SPLIT: {...}`` JSON line; without ``--device cpu`` it needs a
CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

# (module, function) of the step's sub-calls, by the name they are reported under
UNIFORM_PARTS = {"encode_plain (K1)": ("emit", "encode_plain"),
                 "encode_run (K2)": ("emit", "encode_run"),
                 "pack_tags (K3)": ("emit", "pack_tags")}
WIDEST_PARTS = {"lut_gather (K9)": ("lut", "lut_gather_groups"),
                "pack_words (K8)": ("lut", "pack_words"),
                "pack_tags (K3)": ("emit", "pack_tags"),
                "plain_emissions": ("bt", "plain_emissions"),
                "run_setup": ("bt", "run_setup"),
                "run_assemble": ("bt", "run_assemble")}


def _modules():
    from ..ops import bitstream_torch as bt
    from ..ops import emit, lut

    return {"bt": bt, "emit": emit, "lut": lut}


@contextlib.contextmanager
def _recording(parts):
    """Within the block, each function of ``parts`` records (label, function,
    args, kwargs) of its every call into the yielded list."""
    mods = _modules()
    calls, saved = [], []

    def recorder(label, fn):
        def call(*args, **kw):
            calls.append((label, fn, args, kw))
            return fn(*args, **kw)
        return call

    for label, (m, name) in parts.items():
        saved.append((mods[m], name, getattr(mods[m], name)))
        setattr(mods[m], name, recorder(label, getattr(mods[m], name)))
    try:
        yield calls
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _timers(dev: torch.device):
    """time(fn) -> {event_ms, device_ms, ops}: CUDA events and the profiler
    on the card; the host clock of one call on the CPU."""
    if dev.type == "cuda":
        import chip_smoke

        def time_card(fn):
            device, ops = chip_smoke.device_ms(fn)
            return {"event_ms": chip_smoke.cuda_ms(fn), "device_ms": device, "ops": ops}
        return time_card

    def time_host(fn):
        t0 = time.perf_counter()
        fn()
        return {"host_ms": (time.perf_counter() - t0) * 1e3}
    return time_host


def split_batch(batch, parts, dev: torch.device) -> dict:
    """The step on ``batch`` ((arguments, run_on) of ``testing.step_batch``
    or ``widest_bucket_batch``) and each of its sub-calls in ``parts``,
    timed on ``dev``."""
    from ..parallel.pipeline import qv_encode_step

    args, run_on = batch
    dargs = [torch.from_numpy(a).to(dev) for a in args]
    with _recording(parts) as calls:
        qv_encode_step(*dargs, run_on=run_on)
    timed = _timers(dev)
    out = {"streams": list(args[0].shape), "run_on": list(run_on), "parts": {}}
    for label, fn, a, kw in calls:
        t = timed(lambda: fn(*a, **kw))
        part = out["parts"].setdefault(label, {"calls": 0, **dict.fromkeys(t, 0.0)})
        part["calls"] += 1
        for k, v in t.items():
            part[k] = None if v is None or part[k] is None else part[k] + v
    out["step"] = timed(lambda: qv_encode_step(*dargs, run_on=run_on))
    for k, v in out["step"].items():
        if k == "ops":
            continue
        each = [p[k] for p in out["parts"].values()]
        out[f"glue_{k}"] = None if v is None or None in each else v - sum(each)
    return out


def split(uniform: bytes, long: bytes, device="cuda") -> dict:
    """The SPLIT record: ``split_batch`` of the uniform .quiva's step and of
    the long-read .quiva's widest bucket."""
    from ..testing import step_batch, widest_bucket_batch
    from .decode_ablate import card_line

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run on the CPU)")
    return {"device": str(dev), "card": card_line(dev),
            "timer": ("CUDA events (event_ms, median of 5 rounds of 20 calls) and "
                      "profiler device time (device_ms, warm), a call"
                      if dev.type == "cuda" else "host clock, the one call (no device time)"),
            "uniform": split_batch(step_batch(uniform), UNIFORM_PARTS, dev),
            "widest": split_batch(widest_bucket_batch(long), WIDEST_PARTS, dev)}


def main(argv=None) -> int:
    from ..testing import long_quiva, uniform_quiva

    p = argparse.ArgumentParser(prog="python -m dextractor_tpu_torch.tools.encode_split",
                                description="Time each sub-call of the encode step.")
    p.add_argument("--mb", type=int, default=16, help="payload size (MB), as bench.py's")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    res = split(uniform_quiva(a.mb), long_quiva(a.mb), a.device)
    print("SPLIT: " + json.dumps(dict(mb=a.mb, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
