"""The benchmark's files: every cell of ``BENCHMARK.json`` resolves by name
to its configuration, traffic mix, generator, limits and metric readers,
and
the file keeps the benchmark contract's shape."""

import json
import os
import re

import pytest

from portbench import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = harness.resolve(workload, SPEC)
    assert cell.config and cell.mix and cell.limits
    drv = cell.generator()
    for fn in ("setup", "window", "traced", "check"):
        assert callable(getattr(drv, fn))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        path = os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py")
        reader = harness.load_module(path, harness.safe(m["name"]))
        assert callable(reader.read)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = harness.load_json(os.path.join(harness.ROOT, entry["file"]))
    assert entry["file"].startswith("portbench/")
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"]


def test_per_layer_metrics_name_their_cells():
    cells = set(CELLS)
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"])
        e2e = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(e2e.get("workloads", cells))


def test_every_file_is_found_by_some_name():
    """Each configuration, mix, limits and metric file under the benchmark
    belongs to an entry of ``BENCHMARK.json`` (no orphan a cell never
    reads)."""
    mixes = {w["traffic"] for w in SPEC["workloads"]}
    metrics = {m["name"] for m in SPEC["per_layer"]}
    listing = {
        "traffic": {f[:-5] for f in os.listdir(
            os.path.join(harness.BENCH_DIR, "traffic"))},
        "metrics": {f[:-3] for f in os.listdir(
            os.path.join(harness.BENCH_DIR, "metrics")) if f.endswith(".py")},
        "limits": {f[:-5] for f in os.listdir(
            os.path.join(harness.BENCH_DIR, "limits"))},
    }
    assert listing["traffic"] == mixes
    assert listing["metrics"] == metrics
    assert listing["limits"] == set(CELLS)
