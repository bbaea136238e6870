"""BENCHMARK.json keeps the benchmark's contract, and every piece it names
loads by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark_spec()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py" and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
            if kind in ("end_to_end", "per_layer"):
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_loads_and_reports_its_metrics(w):
    cell = spec.cell(w["name"])
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert w["chips"] == 1
    assert len(w["why"]) <= 200
    entry = spec.entry(cell["entry"])
    assert hasattr(entry, "Job") and entry.FAULTS
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.metrics_for(BENCH, w["name"], "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)
    assert set(cell["check"]) and all(v > 0 for v in cell["check"].values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = spec.config(c["name"])
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"].split(".")[0]:
            assert m["unit"] == "%"
            assert m["better"] == "higher"
