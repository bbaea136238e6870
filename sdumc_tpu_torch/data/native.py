"""ctypes binding to the data plane's C++ library (``csrc/sdumc_data.cc``).

A thread-pooled reader that pads or mean-pool-compresses each clip straight
into a ``[B, bucket, dim]`` batch buffer, with the semantics of
``collate.mapping_feature``: from ``.npy`` files (``fill_batch``) or from
a packed store's memory-mapped blob in its payload dtype
(``fill_batch_packed``). The library builds at first use with the host
compiler (``ops/kernels/build.py``, into ``build/native/``); a failed build
or load raises, and nothing falls back to the numpy path.

A destination is a C-contiguous numpy array or a contiguous CPU torch
tensor (page-locked or not) of the batch's shape and dtype: float32, bf16
(a torch bf16 tensor, or its uint16 bit patterns in numpy, as the packed
store keeps them) or int8.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sdumc_tpu_torch.ops.kernels import build

# the packed fill's payload dtypes: the C ABI's code, numpy's dtype, torch's
DTYPES = {"float32": (0, np.dtype(np.float32), torch.float32),
          "bfloat16": (1, np.dtype(np.uint16), torch.bfloat16),
          "int8": (2, np.dtype(np.int8), torch.int8)}

_i64p = ctypes.POINTER(ctypes.c_int64)
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if the build or
    the load fails."""
    global _lib
    if _lib is None:
        lib = build.load("sdumc_data")
        lib.sdumc_fill_batch.restype = ctypes.c_int
        lib.sdumc_fill_batch.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_void_p, _i64p]
        lib.sdumc_fill_batch_packed2.restype = ctypes.c_int
        lib.sdumc_fill_batch_packed2.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, _i64p, ctypes.c_int, _i64p]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _destination(out, shape: tuple, dtype: str):
    """(out, its address): a fresh uninitialised numpy array where `out` is
    None (the fills write every byte), else `out` once checked."""
    _, np_dtype, torch_dtype = DTYPES[dtype]
    if out is None:
        out = np.empty(shape, np_dtype)
    if isinstance(out, torch.Tensor):
        ok = (out.device.type == "cpu" and out.dtype == torch_dtype and out.is_contiguous()
              and tuple(out.shape) == shape)
        addr = out.data_ptr()
    else:
        ok = (out.dtype == np_dtype and out.flags.c_contiguous and out.flags.writeable
              and out.shape == shape)
        addr = out.ctypes.data
    if not ok:
        raise ValueError(f"the destination must be a contiguous, writable {dtype} CPU "
                         f"array or tensor of shape {shape}")
    return out, addr


def fill_batch(paths: Sequence[str], bucket: int, dim: int, out=None):
    """Read the ``.npy`` files at `paths` (``<f4`` or ``<f8``, [T, D] or an
    utterance-level [D]) in parallel into a zero-padded float32 [B, bucket,
    dim] batch, each clip longer than `bucket` mean-pooled into it. Returns
    (batch, [B] int64 lengths after the cap); raises IOError if a file is
    missing or unreadable, or has more than `dim` channels."""
    lib = load_library()
    b = len(paths)
    out, addr = _destination(out, (b, bucket, dim), "float32")
    lengths = np.empty((b,), np.int64)
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    if lib.sdumc_fill_batch(blob, b, bucket, dim, addr, _ptr(lengths)) != 0:
        raise IOError(f"the batch fill failed for one of {b} files")
    return out, lengths


def fill_batch_packed(bin_path: str, entries, bucket: int, dim: int, dtype: str = "float32",
                      out=None, prev_lengths: Optional[np.ndarray] = None
                      ) -> Tuple[object, np.ndarray]:
    """Fill a [B, bucket, dim] batch of a packed store's payload (``dtype``
    "float32", "bfloat16" or "int8": codes 0, 1, 2 of the C ABI) from its
    blob at `bin_path`: each clip zero-padded, or mean-pooled into
    `bucket` in f32 and cast back (bf16 to nearest even, int8 toward
    zero). ``entries`` are the clips' (element offset, rows, cols), as
    tuples or as the three arrays of ``PackedSource.entry_arrays``.

    Every byte of the batch is written once, so a fresh one is allocated
    uninitialised. A buffer refilled in a ring passes ``out`` with
    ``prev_lengths``, the lengths its previous fill returned: the pad rows
    past them are still zero and are not written again. Returns (batch,
    [B] int64 lengths after the cap); raises IOError if a clip lies outside
    the blob or has more than `dim` channels."""
    lib = load_library()
    code = DTYPES[dtype][0]
    if isinstance(entries, tuple) and len(entries) >= 3 and isinstance(entries[0], np.ndarray):
        offs, rows, cols = (np.ascontiguousarray(a, np.int64) for a in entries[:3])
    else:
        offs, rows, cols = (np.ascontiguousarray([e[i] for e in entries], np.int64)
                            for i in range(3))
    b = len(offs)
    prev = None
    if out is not None and prev_lengths is not None:
        prev = np.ascontiguousarray(prev_lengths, np.int64)
        if prev.shape != (b,):
            raise ValueError(f"prev_lengths must have shape ({b},), got {prev.shape}")
    out, addr = _destination(out, (b, bucket, dim), dtype)
    lengths = np.empty((b,), np.int64)
    rc = lib.sdumc_fill_batch_packed2(os.fsencode(bin_path), _ptr(offs), _ptr(rows), _ptr(cols),
                                      b, bucket, dim, addr, _ptr(lengths), code,
                                      None if prev is None else _ptr(prev))
    if rc != 0:
        raise IOError(f"the packed batch fill failed ({b} clips of {bin_path})")
    return out, lengths
