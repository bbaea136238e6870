"""sdumc_tpu_torch stands alone: importing every one of its modules pulls in
neither JAX (jax, flax, optax), nor anything of the JAX package sdumc_tpu,
nor transformers or safetensors (its HF loaders read the checkpoint files,
safetensors included, and the tokenizers' files themselves),
nor Pillow or pandas (the card's machine has neither), nor ml_dtypes (JAX's
dependency: the port keeps bf16 on the host as uint16 bit patterns), and
its sources name none of them in an import, save one: the image reader
imports Pillow lazily for the formats it does not read itself."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sdumc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sdumc_tpu", "transformers", "safetensors")
HOST_LIBS = ("PIL", "pandas", "ml_dtypes")   # not known on the card's machine

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
        [sys.executable, "-c", _PROBE.format(repo=str(REPO), forbidden=FORBIDDEN + HOST_LIBS)],
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


def _imports(node, fn=None):
    """(module, innermost enclosing function name) of every import below node."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            yield from ((a.name, fn) for a in child.names)
        elif isinstance(child, ast.ImportFrom):
            yield child.module or "", fn
        yield from _imports(child, child.name if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)


def test_only_the_image_reader_names_pillow():
    """PIL is imported in one place, inside the function that reads the
    formats the port does not decode itself; pandas nowhere."""
    sites = {(str(path.relative_to(REPO)), fn)
             for path in sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
             for mod, fn in _imports(ast.parse(path.read_text()))
             if mod.split(".")[0] in HOST_LIBS}
    assert sites == {("sdumc_tpu_torch/extract/image_io.py", "_read_with_pillow")}, sites


VISION_MODULES = ("models/vit.py", "models/clip_vit.py", "models/dinov2.py",
                  "models/videomae.py", "models/eva02.py", "models/resnet.py",
                  "convert/hf_clip.py", "convert/hf_dinov2.py", "convert/hf_videomae.py",
                  "convert/timm_eva02.py", "convert/torch_resnet.py", "extract/vision_hf.py")
# all that the vision stage's modules import: the standard library's few, numpy, torch
# and the port itself (the bicubic resize is image_io's, whose Pillow fallback is lazy)
VISION_IMPORTS = {"__future__", "argparse", "dataclasses", "glob", "json", "math", "os", "time",
                  "typing", "numpy", "torch", "sdumc_tpu_torch"}


@pytest.mark.parametrize("rel", VISION_MODULES)
def test_vision_modules_import_only_numpy_torch_and_the_port(rel):
    mods = {mod.split(".")[0] for mod, _ in _imports(ast.parse((PACKAGE / rel).read_text()))}
    assert mods <= VISION_IMPORTS, mods - VISION_IMPORTS
