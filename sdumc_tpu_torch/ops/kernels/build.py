"""Build and load the package's hand-written CUDA kernels.

Each source under ``sdumc_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which
``ctypes`` loads. The build happens at first use, into ``build/kernels/``
at the root of the checkout; the file name carries a hash of the source,
of every header under ``csrc/`` (``*.cuh``) and of the flags, so an edited
source or header is rebuilt and a stale library never loads.
``build()`` compiles several sources at once, one ``nvcc`` process each.
Run as a script (``python sdumc_tpu_torch/ops/kernels/build.py``, which
imports nothing but the standard library), it builds every source and
prints ``build()``'s report as JSON: a caller can build ahead while it
imports torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = {"fused_cross": "csrc/fused_cross.cu", "flash_wavlm": "csrc/flash_wavlm.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1((PACKAGE_DIR / SOURCES[name]).read_bytes())
    for header in sorted((PACKAGE_DIR / "csrc").glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all in parallel.

    Returns {name: {"seconds": wall time, "log": nvcc's stderr (ptxas
    register and shared-memory report)}}; raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(PACKAGE_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0,
                        "log": stdout + stderr}
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"{name}:\n{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


if __name__ == "__main__":
    import json
    import sys

    json.dump(build(), sys.stdout)
