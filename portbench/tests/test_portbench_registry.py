"""BENCHMARK.json against the benchmark's contract, and the registry that
finds every cell's parts by name, a new one with no edit."""

import json
import os
import re
import shutil

import pytest

from core import kinds, registry
from tiny import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|expert|width")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("load", [registry.load, bench], ids=["registered", "with_waiting"])
def test_benchmark_json_keeps_the_contract(load):
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) <= 64 * 1024
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            body = json.load(f)
        for key in c["reduced"]:
            assert NAME.match(key) and key in body and not WIDTHS.search(key)
    assert len({c["file"] for c in b["configs"]}) == len(cfgs)
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
    assert {w["config"] for w in b["workloads"]} == set(cfgs)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for w in cells:
        reported = registry.metrics(b, w, False)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2
        per = registry.metrics(b, w, True)
        assert per and all(m["moves"] in names for m in per)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("load", [registry.load, bench], ids=["registered", "with_waiting"])
def test_every_part_is_found_by_name(load):
    b = load()
    for w in b["workloads"]:
        assert registry.config(b, w["config"])["name"] == w["config"]
        assert registry.traffic(w["traffic"])["kind"] in kinds.KINDS
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_a_new_cell_and_metric_are_found_with_no_edit(tmp_path):
    """A later change adds a traffic file, a metric file and their entries:
    the registry finds them, and no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(registry.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = registry.load()
    (root / "portbench" / "traffic" / "restore_long_window.json").write_text(
        json.dumps({"kind": "restore", "files": 3}))
    (root / "portbench" / "metrics" / "codec.tables_pct.restore.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    b["workloads"].append({"name": "rs2-2kb.restore", "config": "rs2-2kb",
                           "traffic": "restore_long_window", "chips": 1, "why": "a new cell"})
    b["end_to_end"][0]["workloads"].append("rs2-2kb.restore")
    b["per_layer"].append({"name": "codec.tables_pct.restore", "unit": "%", "better": "lower",
                           "source": "program_span", "layer": "codec", "moves": "restore_MBps",
                           "workloads": ["rs2-2kb.restore"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    nb = registry.load(str(root))
    cell = registry.cell(nb, "rs2-2kb.restore")
    assert registry.traffic(cell["traffic"], str(root))["files"] == 3
    assert registry.config(nb, cell["config"], str(root))["reads_per_file"] == 6400
    per = [m["name"] for m in registry.metrics(nb, "rs2-2kb.restore", True)]
    assert per == ["codec.tables_pct.restore"]
    assert registry.reader("codec.tables_pct.restore", str(root))({}) == 1.5
    for sub in ("core", "ref"):
        for f in os.listdir(os.path.join(registry.ROOT, "portbench", sub)):
            if f.endswith(".py"):
                assert (root / "portbench" / sub / f).read_bytes() == open(
                    os.path.join(registry.ROOT, "portbench", sub, f), "rb").read()


def test_an_unknown_name_is_refused():
    b = registry.load()
    with pytest.raises(KeyError):
        registry.cell(b, "no-such.cell")
