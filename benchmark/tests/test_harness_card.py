"""Each cell at its own size on a card: a short window reads correct, and the
TF32 control fails a limit. Skips without a CUDA card."""

from __future__ import annotations

import time

import pytest

from benchmark.lib import runner, spec, trace

CELLS = [w["name"] for w in spec.benchmark_spec()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    out = runner.run(name, 2 ** 31 + 101, 2.0, False, card, time.time())
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    import torch

    w = spec.workload(spec.benchmark_spec(), name)
    cell, cfg = spec.cell(name), spec.config(w["config"])
    job = spec.entry(cell["entry"]).Job(cfg, cell, 2 ** 31 + 202, card, trace.Spans())
    job.window(2.0)
    job.release()
    torch.cuda.empty_cache()
    readings = job.control()
    assert any(readings[k] > limit for k, limit in cell["check"].items()), readings
