"""BENCHMARK.json keeps to the contract's shapes, and every cell's files
resolve by name: a cell, configuration or metric is added by adding files
and entries, with no edit to a file that is there."""

import json
import os
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def ready():
    """Cells kept ready under `ready/`, each file in BENCHMARK.json's layout."""
    d = os.path.join(harness.BENCH, "ready")
    return [harness.load_json(os.path.join(d, f)) for f in sorted(os.listdir(d))]


def test_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert len(json.dumps(b)) <= 64 * 1024
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_names_units_and_text():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in b["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_bounds_and_moves():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= reports
        if m["name"].endswith("roofline") or "roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell reports set-up, another end-to-end metric and a per-layer one
        assert sum(w in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_a_full_check_fits_its_time_budget():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [w["name"] for b in [bench()] + ready() for w in b["workloads"]])
def test_every_cell_resolves_by_name(name):
    cell = harness.cell(name)
    drv = cell["workload"]["driver"]
    assert os.path.exists(os.path.join(harness.BENCH, "drivers", drv + ".py"))
    assert callable(harness.driver(drv).run)
    e2e = {m["name"] for m in cell["end_to_end"]}
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e
    assert cell["workload"]["limits"]
    listed = [w["name"] for w in bench()["workloads"]]
    assert (name in listed) != os.path.exists(
        os.path.join(harness.BENCH, "ready", name + ".json"))


def test_every_config_is_used_and_its_file_is_its_own():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["file"].startswith("port_bench/")
        assert harness.load_json(os.path.join(harness.ROOT, c["file"]))["name"] == c["name"]
