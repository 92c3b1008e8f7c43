"""The metrics' arithmetic: a reader with nothing to read returns None, and
a run keeps Python's bytecode inside the checkout."""

import os
import subprocess
import sys

import pytest

from core import formulas, registry
from tiny import bench

EMPTY = dict(spans=None, trace=None, launches={}, calls=4, host_s=[0.002] * 4, traced=[],
             traced_window_s=None, work_bytes_traced=None, peak_bytes_per_s=None,
             payload_bytes=10**9, window_s=2.0, setup_s=9.0)


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_a_per_layer_reader_with_nothing_to_read_returns_none(metric):
    m = next(x for x in bench()["per_layer"] if x["name"] == metric)
    value = registry.reader(metric)(dict(EMPTY))
    if m["source"] == "host_clock":
        assert value == pytest.approx(2.0)
    else:
        assert value is None


def test_the_formulas_on_a_traced_run():
    ctx = dict(EMPTY, spans={"rects": 1.5, "step": 0.5}, traced_window_s=3.0,
               trace={"busy_s": 0.75, "window_s": 3.0, "own_s": 0.25, "device_s": 1.0},
               launches={"k1": 8, "k2": 4}, traced=[0, 1], host_s=[9.0, 9.0, 0.001, 0.003],
               work_bytes_traced=3.35e9, peak_bytes_per_s=3.35e12)
    assert formulas.rate(ctx, 1e6) == pytest.approx(500.0)
    assert formulas.span_share(ctx, ("rects", "step")) == pytest.approx(200.0 / 3)
    assert formulas.idle_pct(ctx) == pytest.approx(75.0)
    assert formulas.own_kernel_pct(ctx) == pytest.approx(25.0)
    assert formulas.launches_per_call(ctx) == pytest.approx(3.0)
    assert formulas.host_ms(ctx) == pytest.approx(2.0)          # the untraced calls
    assert formulas.roofline(ctx) == pytest.approx(100.0 * 1e-3 / 0.75)


def test_a_run_keeps_python_s_bytecode_in_the_checkout():
    here = os.path.join(registry.ROOT, "portbench")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import run; run.prepare(); "
            "print(sys.pycache_prefix, sys.dont_write_bytecode)")
    out = subprocess.run([sys.executable, "-c", code, here], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    prefix, dont = out.stdout.split()
    assert prefix == os.path.join(here, "_cache", "pyc") and dont == "False"
