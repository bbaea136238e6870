"""The benchmark of sdumc_tpu_torch on one NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: builds its inputs and weights from the
seed, warms the program, drives it for the window, checks what it produced
against the plain reference, and prints the result as one JSON line, the
last of standard output; the compared numbers with their limits are the
last lines of standard error. ``--trace 1`` traces the window with
torch.profiler and reports the per-layer metrics instead of the
end-to-end ones. Without a CUDA card, or without the program beside the
benchmark, it exits with code 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library pulls JAX in."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    from benchmark.lib import runner, spec

    bench = spec.benchmark_spec()
    w = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"the cell {args.workload} needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        import sdumc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START, spec=bench)
    for name, (value, limit) in out["compared"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        # a failed run exits at once: its input pipeline's threads must not
        # hold the interpreter at shutdown
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
