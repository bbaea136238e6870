"""sdumc_tpu_torch stands alone: importing every one of its modules pulls in
neither JAX (jax, flax, optax), nor anything of the JAX package sdumc_tpu,
nor transformers or safetensors (its HF loaders read the checkpoint files,
safetensors included, and the tokenizers' files themselves), nor
tokenizers, sentencepiece or regex (the card's machine has none of them:
the tokenizer readers parse tokenizer.json, vocab files and SentencePiece
models themselves and translate the regexes to ``re``),
nor Pillow or pandas (the card's machine has neither), nor ml_dtypes (JAX's
dependency: the port keeps bf16 on the host as uint16 bit patterns), and
its sources name none of them in an import, save one: the image reader
imports Pillow lazily for the formats it does not read itself. pyyaml is
not imported either: the tuner imports it lazily, to read a grid file."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sdumc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sdumc_tpu", "transformers", "safetensors",
             "tokenizers", "sentencepiece", "regex")
HOST_LIBS = ("PIL", "pandas", "ml_dtypes")   # not known on the card's machine
LAZY_LIBS = ("yaml",)                        # imported only inside the one function that reads it

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
        [sys.executable, "-c", _PROBE.format(repo=str(REPO),
                                             forbidden=FORBIDDEN + HOST_LIBS + LAZY_LIBS)],
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


def test_only_the_tuner_names_yaml_lazily():
    """pyyaml is imported in one place, inside the function that reads a
    grid file (the card's machine may lack it)."""
    sites = {(str(path.relative_to(REPO)), fn)
             for path in sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
             for mod, fn in _imports(ast.parse(path.read_text()))
             if mod.split(".")[0] in LAZY_LIBS}
    assert sites == {("sdumc_tpu_torch/core/tuner.py", "load_grids")}, sites


BASELINE_MODULES = ("models/baselines.py", "models/baselines_seq.py",
                    "models/modules/__init__.py", "models/modules/linen.py",
                    "models/modules/transformer_encoder.py", "core/tuner.py",
                    "core/model_registry.py", "losses.py")


def test_the_walk_imports_the_baseline_modules():
    """pkgutil's walk reaches the baseline zoo's modules, models/modules
    included (so the probe above covers them)."""
    import pkgutil

    import sdumc_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sdumc_tpu_torch.__path__, "sdumc_tpu_torch.")}
    for rel in BASELINE_MODULES:
        name = "sdumc_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
        assert name in names, name


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


TEXT_MODULES = ("models/bert.py", "models/albert.py", "models/deberta.py", "models/bloom.py",
                "models/glm.py", "convert/hf_text.py", "convert/hf_bert.py",
                "convert/hf_albert.py", "convert/hf_deberta.py", "convert/hf_bloom.py",
                "convert/hf_glm.py", "convert/hf_tokenizer.py", "convert/vocab_tokenizers.py",
                "data/raw_text.py", "extract/text.py")
# all that the text families' modules import: the standard library's few, numpy, torch
# and the port itself
TEXT_IMPORTS = {"__future__", "argparse", "base64", "csv", "dataclasses", "functools", "glob",
                "hashlib", "importlib", "json", "math", "os", "re", "struct", "sys", "time",
                "typing", "unicodedata", "numpy", "torch", "sdumc_tpu_torch"}


def test_the_walk_imports_the_text_family_modules():
    """pkgutil's walk reaches the text families' modules (models, loaders,
    tokenizer readers, raw_text), so the probe above covers them."""
    import pkgutil

    import sdumc_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sdumc_tpu_torch.__path__, "sdumc_tpu_torch.")}
    for rel in TEXT_MODULES:
        assert "sdumc_tpu_torch." + rel[:-3].replace("/", ".") in names, rel


@pytest.mark.parametrize("rel", TEXT_MODULES)
def test_text_modules_import_only_numpy_torch_and_the_port(rel):
    mods = {mod.split(".")[0] for mod, _ in _imports(ast.parse((PACKAGE / rel).read_text()))}
    assert mods <= TEXT_IMPORTS, mods - TEXT_IMPORTS


SERVE_MODULES = ("serve/__init__.py", "serve/export.py", "cli/export.py")


def test_the_walk_imports_the_serving_modules():
    """pkgutil's walk reaches the serving export and its CLI, so the probe
    above covers them."""
    import pkgutil

    import sdumc_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sdumc_tpu_torch.__path__, "sdumc_tpu_torch.")}
    for rel in SERVE_MODULES:
        assert "sdumc_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__") in names, rel


def test_the_serving_module_imports_no_model_code_at_load():
    """serve/export.py names no module of sdumc_tpu_torch.models at its top
    level (a process that loads a bundle imports none; the export itself
    reaches the model through train.step, inside the function that traces
    it), and it registers the fusion kernel's op there."""
    tree = ast.parse((PACKAGE / "serve/export.py").read_text())
    top = [mod for mod, fn in _imports(tree) if fn is None]
    assert "sdumc_tpu_torch.ops.kernels" in top
    assert not any(m.startswith(("sdumc_tpu_torch.models", "sdumc_tpu_torch.train")) for m in top)


PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                    "parallel/sharding.py", "parallel/layers.py", "parallel/ring_attention.py",
                    "parallel/wavlm_sp.py")


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_the_walk_imports_the_parallel_modules(rel):
    """pkgutil's walk reaches the data- and tensor-parallel layer (so the
    probe above covers it)."""
    import pkgutil

    import sdumc_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sdumc_tpu_torch.__path__, "sdumc_tpu_torch.")}
    assert "sdumc_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__") in names


def test_torch_distributed_is_imported_only_inside_functions():
    """No module of the port imports torch.distributed when it is imported
    (a torch built without it must still import the port): every import of
    it sits in a function."""
    sites = {(str(path.relative_to(REPO)), fn)
             for path in sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
             for mod, fn in _imports(ast.parse(path.read_text()))
             if mod.startswith("torch.distributed")}
    assert sites and all(fn is not None for _, fn in sites), sites


TP_MODULES = ("parallel/sharding.py", "parallel/mesh.py", "parallel/layers.py",
              "models/llama.py", "models/wavlm.py",
              "models/generation.py", "convert/hf_llama.py", "extract/llm4wav.py")
# all that the tensor-parallel path's modules import: the standard library's few, numpy,
# torch and the port itself
TP_IMPORTS = {"__future__", "argparse", "dataclasses", "glob", "json", "math", "os", "re",
              "sys", "time", "typing", "numpy", "torch", "sdumc_tpu_torch"}


@pytest.mark.parametrize("rel", TP_MODULES)
def test_tensor_parallel_modules_import_only_numpy_torch_and_the_port(rel):
    """The modules the tensor-parallel extractors run (the split layout,
    the model axis, the split models, the loader and the stages) import no
    JAX and nothing beyond numpy, torch and the standard library."""
    mods = {mod.split(".")[0] for mod, _ in _imports(ast.parse((PACKAGE / rel).read_text()))}
    assert mods <= TP_IMPORTS, mods - TP_IMPORTS


SP_MODULES = ("parallel/ring_attention.py", "parallel/wavlm_sp.py", "parallel/mesh.py",
              "models/wavlm.py", "ops/kernels/flash_wavlm.py")
# all that the sequence-parallel path's modules import: the standard library's few
# (ctypes for the kernel's binding), torch and the port itself
SP_IMPORTS = {"__future__", "contextlib", "ctypes", "dataclasses", "math", "typing", "torch",
              "sdumc_tpu_torch"}


@pytest.mark.parametrize("rel", SP_MODULES)
def test_sequence_parallel_modules_import_only_torch_and_the_port(rel):
    """The modules of ring attention and sequence-parallel WavLM (the ring,
    the SP forward, the axis's rotation, the model and the block kernel's
    wrapper) import no JAX and nothing beyond torch and the standard
    library."""
    mods = {mod.split(".")[0] for mod, _ in _imports(ast.parse((PACKAGE / rel).read_text()))}
    assert mods <= SP_IMPORTS, mods - SP_IMPORTS
