"""Readings that a cell's output-check limits are set from, many seeds in
one process (set-up is long, and a process pays it once per seed anyway).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault NAME:7,8,9 ...] [--seconds 2]

For each seed of ``--seeds`` it runs the cell's set-up and a window of
``--seconds`` (0: none) and prints the program's readings; for each of
``--control-seeds`` the reading of the plain reference computed at TF32 in
the program's place; for each ``--fault`` the readings with that fault
planted in the timed path. One JSON line a run, on standard output and in
``chiprun_out/calibrate-<cell>.jsonl``. Needs a CUDA card.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--look-seeds", default="",
                   help="the reference in the program's place with its weights nudged "
                        "by rounding (entries that define look())")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import spec, trace

    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.benchmark_spec()
    w = spec.workload(bench, args.workload)
    cell, cfg = spec.cell(args.workload), spec.config(w["config"])
    entry = spec.entry(cell["entry"])
    runs = [("program", None, int(s)) for s in args.seeds.split(",") if s]
    runs += [("control", None, int(s)) for s in args.control_seeds.split(",") if s]
    runs += [("look", None, int(s)) for s in args.look_seeds.split(",") if s]
    for f in args.fault:
        name, seeds = f.split(":")
        runs += [("fault", name, int(s)) for s in seeds.split(",") if s]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"calibrate-{args.workload}.jsonl", "a") as log:
        for kind, fault, seed in runs:
            t0 = time.time()
            job = entry.Job(cfg, cell, seed, device, trace.Spans(), fault=fault)
            if args.seconds > 0:
                job.window(args.seconds)
            job.release()
            torch.cuda.empty_cache()
            if kind in ("control", "look"):
                readings = getattr(job, kind)()
            else:
                readings = {n: v for n, v, _ in job.check()}
            line = json.dumps({"workload": args.workload, "kind": kind, "fault": fault,
                               "seed": seed, "readings": readings,
                               "worst": getattr(job, "worst", None),
                               "seconds": time.time() - t0,
                               "card": torch.cuda.get_device_name(device)})
            print(line, flush=True)
            log.write(line + "\n")
            del job
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
