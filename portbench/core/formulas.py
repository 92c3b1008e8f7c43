"""The arithmetic of the metrics, one formula each; a file under
``metrics/`` names its metric's formula and arguments.  BENCHMARK.json's
``workloads`` lists already route each metric to its cells, so a formula
looks only at what it reads: it returns None where a run has nothing to
read (no device trace on a host without a card, no span, no launch)."""

from __future__ import annotations


def rate(ctx: dict, scale: float) -> float:
    """Payload bytes completed in the window over all of its time, in
    bytes / ``scale`` a second."""
    return ctx["payload_bytes"] / ctx["window_s"] / scale


def span_share(ctx: dict, stages) -> float | None:
    """Share, in %, of the traced window in the program's spans ``stages``
    (``utils/profiling.stage``, host clock)."""
    if not ctx["spans"]:
        return None
    return 100.0 * sum(ctx["spans"].get(s, 0.0) for s in stages) / ctx["traced_window_s"]


def host_ms(ctx: dict) -> float:
    """Host-clock ms a call takes to return (its enqueue, and any wait the
    launch queue imposes): the mean over the calls outside the traced part."""
    traced = set(ctx["traced"])
    host = [t for i, t in enumerate(ctx["host_s"]) if i not in traced] or ctx["host_s"]
    return 1e3 * sum(host) / len(host)


def launches_per_call(ctx: dict) -> float | None:
    """Launches of the program's own kernels a call, counted by the program
    (``utils.dispatch.LAUNCHES``) over the window."""
    n = sum(ctx["launches"].values())
    return n / ctx["calls"] if n and ctx["calls"] else None


def own_kernel_pct(ctx: dict) -> float | None:
    """Share, in %, of the traced device time in the program's own kernels
    (the ``__global__`` functions of ``dextractor_tpu_torch/ops/csrc``),
    against every device operation: PyTorch's kernels, copies and sets."""
    a = ctx["trace"]
    return 100.0 * a["own_s"] / a["device_s"] if a and a["device_s"] else None


def idle_pct(ctx: dict) -> float | None:
    """Share, in %, of the traced window in which no operation ran on the
    card."""
    a = ctx["trace"]
    return 100.0 * (1.0 - a["busy_s"] / a["window_s"]) if a and a["busy_s"] else None


def roofline(ctx: dict) -> float | None:
    """Share, in %, of the card's memory roofline: the bytes the traced calls
    have to move at the least (their reads' payload once and their
    compressed streams once, counted from the file) over the published HBM
    bandwidth, against the seconds in which the card was busy."""
    a = ctx["trace"]
    if not a or not a["busy_s"] or not ctx["peak_bytes_per_s"] or not ctx["work_bytes_traced"]:
        return None
    return 100.0 * ctx["work_bytes_traced"] / ctx["peak_bytes_per_s"] / a["busy_s"]
