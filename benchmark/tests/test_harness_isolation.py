"""Nothing that the harness runs imports JAX or the JAX package, judged by
each module's top-level name compared whole (the program's package name
begins with the JAX package's)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sdumc_tpu"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_of_the_harness_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_a_run_loads_no_jax_module():
    """A whole toy run in a fresh process, then its modules' top-level names."""
    code = (
        "import sys, time, torch\n"
        "from benchmark.lib import runner\n"
        "from benchmark.tests import tiny\n"
        "for name in ('fusion-train-mosei', 'wavlm-extract-mosei'):\n"
        "    b, c, f = tiny.cell(name)\n"
        "    runner.run(name, 3, 0.2, False, torch.device('cpu'), time.time(), spec=b, cell=c, cfg=f)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_check_compares_whole_names():
    from benchmark.lib import runner

    assert "sdumc_tpu_torch" not in runner.forbidden_modules()
    assert set(runner.FORBIDDEN) == FORBIDDEN
