"""Every cell, configuration, mix, driver and per-layer metric is a file of
its own that the harness finds by name, and BENCHMARK.json keeps to the
contract's shape."""

import os
import re

import pytest

from h100_bench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(w):
    cell = harness.load_cell(w["name"])
    assert cell["cfg"]["name"] == w["config"]
    assert hasattr(cell["driver_module"], "run")
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    path = os.path.join(harness.BENCH, "metrics", f"{m['name']}.py")
    reader = harness.load_module(path, "m_" + m["name"].replace(".", "_"))
    assert reader.read({"spans": {}, "trace": {}, "cfg": {}}) is None   # nothing to read


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(c):
    cfg = harness.load_json(harness.ROOT, c["file"])
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    assert cfg["source"] == c["source"]
    assert cfg["flux"]["num_layers"] == 19 and cfg["flux"]["num_single_layers"] == 38


def test_contract_shape():
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
