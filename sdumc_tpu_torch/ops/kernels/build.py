"""Build and load the package's hand-written CUDA kernels and its host
data plane.

Each CUDA source under ``sdumc_tpu_torch/csrc/`` (``SOURCES``) is compiled
by ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
which ``ctypes`` loads; the build happens at first use, into
``build/kernels/`` at the root of the checkout. The data plane's C++
(``HOST_SOURCES``: ``csrc/sdumc_data.cc``, the batch fill of
``data/native.py``) is compiled the same way by the host compiler, ``g++``
from ``PATH``, into ``build/native/``: it needs no card, and builds on the
CPU too. A file name carries a hash of the source, of the flags and, for a
CUDA source, of every header under ``csrc/`` (``*.cuh``), so an edited
source or header is rebuilt and a stale library never loads; a library is
written to a temporary file and renamed into place, so processes that
build at once do not collide. A failed compile raises with the
compiler's message. ``build()`` compiles several sources at once, one
compiler process each. Run as a script (``python
sdumc_tpu_torch/ops/kernels/build.py``, which imports nothing but the
standard library), it builds every source and prints ``build()``'s report
as JSON: a caller can build ahead while it imports torch.
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
NATIVE_DIR = PACKAGE_DIR.parent / "build" / "native"
SOURCES = {"fused_cross": "csrc/fused_cross.cu", "flash_wavlm": "csrc/flash_wavlm.cu"}
HOST_SOURCES = {"sdumc_data": "csrc/sdumc_data.cc"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the data plane's library "
                           "(csrc/sdumc_data.cc) builds with the host compiler")
    return found


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        digest = hashlib.sha1((PACKAGE_DIR / HOST_SOURCES[name]).read_bytes())
        digest.update(" ".join(HOST_FLAGS).encode())
        return NATIVE_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    digest = hashlib.sha1((PACKAGE_DIR / SOURCES[name]).read_bytes())
    for header in sorted((PACKAGE_DIR / "csrc").glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, compiler: str, out: str) -> list:
    if name in HOST_SOURCES:
        return [compiler, *HOST_FLAGS, str(PACKAGE_DIR / HOST_SOURCES[name]), "-o", out]
    return [compiler, *NVCC_FLAGS, "-o", out, str(PACKAGE_DIR / SOURCES[name])]


def build(names: Iterable[str] = (*HOST_SOURCES, *SOURCES)) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all in parallel.

    Returns {name: {"seconds": wall time from the start until its compile
    was seen to end (the compiles are awaited in the order of `names`, the
    host library's, a few seconds, before the kernels'), "log": the
    compiler's stderr (for a kernel, ptxas's register and shared-memory
    report)}}; raises if a compiler is missing or any compile fails.
    """
    todo = {name: library_path(name) for name in names}
    todo = {name: out for name, out in todo.items() if not out.exists()}
    compilers = {}
    if any(name in HOST_SOURCES for name in todo):
        compilers["host"] = _cxx()
    if any(name not in HOST_SOURCES for name in todo):
        compilers["cuda"] = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = _command(name, compilers["host" if name in HOST_SOURCES else "cuda"], tmp)
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
        raise RuntimeError("the build failed for " + "\n".join(failed))
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
