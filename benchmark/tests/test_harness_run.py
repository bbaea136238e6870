"""Whole runs of each cell on the CPU at toy sizes, past the look for a
card: the result line's shape, a sound run reads correct, and each fault
planted in the timed path, and the TF32 control, read not correct."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.lib import runner, spec, trace
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELLS = tiny.CELLS
SEED = 2 ** 32 + 17


def _run(name, fault=None, traced=False):
    bench, cell, cfg = tiny.cell(name)
    return runner.run(name, SEED, 0.5, traced, CPU, time.time(), fault=fault, spec=bench,
                      cell=cell, cfg=cfg)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_well_formed(name):
    out = _run(name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in spec.metrics_for(spec.benchmark_spec(), name, "end_to_end")}
    assert set(out["metrics"]) == e2e
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in spec.entry(spec.cell(n)["entry"]).FAULTS])
def test_a_fault_in_the_timed_path_reads_not_correct(name, fault):
    out = _run(name, fault=fault)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_a_limit(name):
    bench, cell, cfg = tiny.cell(name)
    entry = spec.entry(cell["entry"])
    job = entry.Job(cfg, cell, SEED, CPU, trace.Spans())
    job.window(0.2)
    job.release()
    readings = job.control()
    assert any(readings[k] > limit for k, limit in cell["check"].items()), readings


def test_a_traced_run_reports_per_layer_metrics_only():
    out = _run("fusion-train-mosei", traced=True)
    names = {m["name"] for m in spec.metrics_for(spec.benchmark_spec(), "fusion-train-mosei",
                                                  "per_layer")}
    assert set(out["metrics"]) <= names
    assert "data_wait_ms.train" in out["metrics"]       # the CPU run has no device trace
    assert out["correct"] is True
