"""The reduction of a device trace: busy time as the union of device
operations, idle time by the innermost host stage that was open."""

import pytest

from core import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_idle_and_stages():
    ev = [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x("stage:call", "user_annotation", 0, 60),
        _x("stage:rects", "user_annotation", 10, 20),
        _x("stage:call", "user_annotation", 70, 30),
        _x("void (anonymous namespace)::decode_run_kernel<4>(int)", "kernel", 30, 10),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 35, 10),
        _x("void at::native::elementwise_kernel<1>()", "kernel", 80, 5),
        _x("ignored outside", "kernel", 200, 5),
    ]
    a = trace.analyse({"traceEvents": ev}, ["decode_run_kernel"])
    assert a["window_s"] == pytest.approx(100e-6)
    assert a["busy_s"] == pytest.approx(20e-6)          # [30, 45) and [80, 85)
    assert a["device_s"] == pytest.approx(25e-6)
    assert a["own_s"] == pytest.approx(10e-6) and a["own_launches"] == 1
    gaps = a["idle_gaps"]
    assert gaps["rects"] == pytest.approx(20e-6)         # [10, 30)
    assert gaps["_no_stage_"] == pytest.approx(10e-6 + 15e-6 + 10e-6 + 15e-6)
    assert gaps["_between_calls_"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(a["window_s"] - a["busy_s"])
    b = trace.breakdown(a)
    assert b["device_ops"][0][0].startswith("void__anonymous_namespace___decode_run")
    assert all(len(n) <= 64 for n, _ in b["device_ops"] + b["idle_gaps"])


def test_no_window_reads_nothing():
    assert trace.analyse({"traceEvents": []}, []) == {}


def test_the_program_s_kernels_are_found_in_its_sources():
    import os

    from core import registry

    names = trace.own_kernel_names(os.path.join(registry.ROOT, "dextractor_tpu_torch"))
    assert {"decode_plain_kernel", "decode_run_kernel", "expand_runs_kernel",
            "encode_plain_kernel", "encode_run_kernel", "pack_tags_kernel"} <= set(names)
