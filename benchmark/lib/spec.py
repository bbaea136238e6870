"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics; each piece is a file of its own under
``benchmark/``:

- ``configs/<config>.json``: the configuration as it runs.
- ``cells/<cell>.json``: the cell's configuration and traffic names, the
  entry that drives it (``entries/<entry>.py``) and the traffic's
  parameters, and the limits of its output check.
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   + ", ".join(w["name"] for w in spec["workloads"]))


def cell(name: str) -> Dict:
    """The cell file of workload `name`."""
    return load_json(BENCH_DIR / "cells" / f"{name}.json")


def config(name: str) -> Dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def metrics_for(spec: Dict, workload_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that a cell reports: those
    whose ``workloads`` list it, or that have no such list."""
    return [m for m in spec[kind] if workload_name in m.get("workloads", [workload_name])]


def entry(name: str):
    """The module ``benchmark/entries/<name>.py``."""
    return importlib.import_module(f"benchmark.entries.{name}")


def metric_reader(name: str):
    """The module of ``benchmark/metrics/<name>.py`` (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
