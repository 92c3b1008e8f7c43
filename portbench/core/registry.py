"""Find a cell's parts by the names that BENCHMARK.json gives them.

A cell names a configuration, whose file BENCHMARK.json lists, and a
traffic mix, the data file ``portbench/traffic/<traffic>.json``.  A metric
is read by ``portbench/metrics/<metric>.py``, a module with one function
``read(ctx)`` that returns a number or None.  A later cell, configuration,
mix or metric is a new file and a new entry: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench: dict, workload: str) -> dict:
    return _named(bench["workloads"], workload, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "portbench", "traffic", name + ".json")) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A per-layer metric without a
    ``workloads`` list belongs to every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: str = ROOT):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
