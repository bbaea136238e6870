"""One run of one cell: set-up, the measured window, the reading of the
trace, the output check, and the result line.

An entry (``entries/<entry>.py``) defines ``Job(cfg, cell, seed, device,
spans, fault=None)``, whose construction is the set-up (inputs and weights
from the seed, the program built and warmed, and for training the first
steps that the check follows), with:

- ``window(seconds)``: drives the program for `seconds` of host clock,
  returns a ``Window``;
- ``release()``: frees the program's state once the window has closed;
- ``check()``: the comparison with the plain reference, a list of
  ``(name, value, limit)``; the run is correct when every value is at most
  its limit.

``fault`` names a fault planted in the timed path (``FAULTS`` of the
entry); only the tests and the calibration plant one.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

from benchmark.lib import spec as specs
from benchmark.lib import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "sdumc_tpu")


@dataclasses.dataclass
class Window:
    seconds: float                    # host clock, first dispatch to the last result
    e2e: Dict[str, float]             # end-to-end values by metric name
    attempted: int
    failed: int = 0
    flops: float = 0.0                # frozen products of the window's work
    kernel_work: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)
    steps: int = 0                    # steps or batches (for per-step metrics)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads."""

    window: Window
    trace: Optional[tracing.Trace]
    spans: tracing.Spans
    peaks: Optional[Dict[str, float]]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``sdumc_tpu_torch`` is not ``sdumc_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(workload_name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        fault: Optional[str] = None, spec: Optional[Dict] = None,
        cell: Optional[Dict] = None, cfg: Optional[Dict] = None) -> Dict:
    """The result line's object, with its compared numbers under
    ``compared`` (name -> [value, limit]) as the last key."""
    spec = spec or specs.benchmark_spec()
    w = specs.workload(spec, workload_name)
    cell = cell or specs.cell(workload_name)
    cfg = cfg or specs.config(w["config"])
    entry = specs.entry(cell["entry"])

    spans = tracing.Spans(traced=traced)
    job = entry.Job(cfg, cell, seed, device, spans, fault=fault)
    try:
        return _measure(job, spec, w, cell, workload_name, seconds, traced, device, t_start, spans)
    finally:
        job.release()


def _measure(job, spec, w, cell, workload_name, seconds, traced, device, t_start, spans):
    import torch

    from benchmark.counts import peaks

    cuda = torch.device(device).type == "cuda"
    spans.seconds.clear()
    spans.counts.clear()
    setup_s = time.time() - t_start
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        length = min(seconds, cell.get("trace_seconds", seconds))
        with profile(activities=acts) as prof:
            with record_function(tracing.PREFIX + "window"):
                win = job.window(length)
    else:
        win = job.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run holds modules it may not load: {', '.join(found)}")
    trace = tracing.read(prof) if prof is not None else None
    job.release()
    if cuda:
        torch.cuda.empty_cache()
    compared = job.check()
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in compared)

    metrics = {}
    if not traced:
        for m in specs.metrics_for(spec, workload_name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else win.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        view = RunView(win, trace, spans, peaks(name))
        for m in specs.metrics_for(spec, workload_name, "per_layer"):
            value = specs.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": w["chips"],
        "memory_peak_bytes": memory_peak,
    }
    out = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in trace.device_ops],
                            "idle_gaps": [list(x) for x in trace.idle_gaps]}
    out["compared"] = {n: [_finite(v), limit] for n, v, limit in compared}
    return out


def _finite(v: float) -> float:
    """A reading as JSON can hold it: a non-finite one as 1e308."""
    return float(v) if math.isfinite(v) else 1e308
