"""Whole runs of every cell on the CPU (the program's twins), past the
harness's look for a card: the result line's keys, the metrics each run
reports, and a run without a card that fails rather than falls back."""

import json
import os
import subprocess
import sys

import pytest

from core import registry
from tiny import CELLS, bench, run

REGISTERED = [w["name"] for w in registry.load()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_reports_the_contract_s_keys(workload, trace):
    result, checks = run(workload, trace=trace)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert all(v == 0 and lim == 0 for v, lim in checks.values())
    assert json.loads(json.dumps(result)) == result
    names = {m["name"] for m in registry.metrics(bench(), workload, trace)}
    got = set(result["metrics"])
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
        # the CPU has no device trace: what is read from it stays out
        assert got <= names and got
    else:
        assert got == names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", REGISTERED[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.chip
@pytest.mark.parametrize("workload", REGISTERED)
def test_a_short_run_on_the_card_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available here)")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "2", "--seconds", "2", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
