"""sdumc_tpu_torch stands alone: importing every one of its modules pulls in
neither JAX (jax, flax, optax) nor anything of the JAX package sdumc_tpu,
and its sources name none of them in an import."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sdumc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sdumc_tpu")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
before = set(sys.modules)
import sdumc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sdumc_tpu_torch.__path__, "sdumc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
forbidden = {forbidden!r}
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in forbidden)
print(len(names), bad)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_pulls_in_no_jax():
    run = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO), forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    count, bad = run.stdout.split(" ", 1)
    assert int(count) >= 20, run.stdout      # every module was imported
    assert bad.strip() == "[]", bad


def test_sources_import_no_jax():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {m}" for m in mods if _forbidden(m)]
    assert offenders == []
