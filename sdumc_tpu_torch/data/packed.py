"""Packed single-file feature store: the production input path.

All of a feature type's ``[T, D]`` clips concatenated into one blob with a
JSON index, read through one memory map:

    pack:   {dir}/{clip}.npy ...  ->  {out}.bin + {out}.json [+ {out}.scales.bin]
    read:   PackedSource(out).get(clip) -> float32 [T, D]

The payload is float32 (the checkpoint-parity path), bfloat16 (half the
bytes; the fusion net then runs bf16 frame streams) or int8 (half again):
per-clip, per-channel symmetric scales ([cols] f32 a clip) sit in the
``.scales.bin`` sidecar, at offsets the index holds, and the train and eval
steps dequantise on the device (``train/step.py dequant_features``). The
blob, the index and the sidecar are byte-identical to the JAX package's
``sdumc_tpu/data/packed.py``, so a store packed by either package reads in
the other.

bf16 on the host is its bit pattern in a ``uint16`` array (numpy has no
bf16 type; the JAX package's ``ml_dtypes`` is not a dependency of the
port). Converting to it rounds f32 to nearest even, through torch, the cast
the card makes too. ``get`` widens such a clip to f32 (exact) and
dequantises an int8 clip to f32, for the generic consumers; the batch fill
(``fill_batch_from_packed``, the C++ fill of data/native.py over the
memory-mapped blob) keeps the payload as it is. ``fill_batch_from_packed_plain``
is its plain numpy version, which the tests hold it to.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sdumc_tpu_torch.data import native
from sdumc_tpu_torch.data.collate import mapping_feature


def payload_dtype(name: str) -> np.dtype:
    """The numpy dtype of a store's payload: uint16 bit patterns for bf16."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of bf16, rounded to nearest even
    (a wider input is taken to f32 first)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """The uint16 bit patterns of bf16 -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_clip(arr: np.ndarray):
    """Symmetric per-channel int8: [T, D] f32 -> (int8 [T, D], f32 [D]
    scales). absmax / 127 per channel; an all-zero channel gets scale 1 so
    the round trip stays exactly zero."""
    amax = np.abs(arr).max(axis=0).astype(np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(arr / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def pack_features(src_dir: str, out_prefix: str, names: Optional[Sequence[str]] = None,
                  dtype: str = "float32") -> str:
    """Pack ``{src_dir}/{clip}.npy`` (all of them, sorted, or ``names``)
    into ``{out_prefix}.bin`` + ``.json`` (+ ``.scales.bin`` for int8) with
    a ``dtype`` payload; returns ``out_prefix``."""
    # os.listdir, not glob: the live feat4 directory's name holds "[...]",
    # which a glob pattern reads as a character class
    files = (
        [os.path.join(src_dir, n + ".npy") for n in names]
        if names is not None
        else sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                    if f.endswith(".npy"))
    )
    quant = dtype == "int8"
    dt = payload_dtype(dtype)
    index: Dict[str, list] = {}
    offset = 0
    scale_off = 0
    scales_f = open(out_prefix + ".scales.bin", "wb") if quant else None
    try:
        with open(out_prefix + ".bin", "wb") as blob:
            for path in files:
                arr = np.load(path)
                if arr.ndim == 1:
                    arr = arr[None, :]
                clip = os.path.basename(path)[:-4]
                if quant:
                    q, scale = quantize_clip(np.asarray(arr, np.float32))
                    # index entry: [offset, rows, cols, scale_offset]
                    index[clip] = [offset, int(q.shape[0]), int(q.shape[1]), scale_off]
                    blob.write(np.ascontiguousarray(q).tobytes())
                    scales_f.write(scale.tobytes())
                    offset += q.size
                    scale_off += scale.size
                else:
                    arr = bf16_bits(arr) if dtype == "bfloat16" else arr.astype(dt)
                    arr = np.ascontiguousarray(arr)
                    index[clip] = [offset, int(arr.shape[0]), int(arr.shape[1])]
                    blob.write(arr.tobytes())
                    offset += arr.size
    finally:
        if scales_f is not None:
            scales_f.close()
    with open(out_prefix + ".json", "w") as f:
        json.dump({"dtype": dtype, "index": index}, f)
    return out_prefix


class PackedSource:
    """Feature source over a packed blob, with NpyDirSource's protocol (get /
    dim / length_of); memory-mapped, so reads are lazy and shared."""

    def __init__(self, prefix: str, name: str = "packed"):
        self.name = name
        with open(prefix + ".json") as f:
            meta = json.load(f)
        self._index = meta["index"]
        self.dtype_name = meta.get("dtype", "float32")
        self.payload_dtype = payload_dtype(self.dtype_name)
        self.bin_path = prefix + ".bin"
        self._blob = np.memmap(self.bin_path, dtype=self.payload_dtype, mode="r")
        self._scales = (np.memmap(prefix + ".scales.bin", dtype=np.float32, mode="r")
                        if self.dtype_name == "int8" else None)
        self._scales_mat = None
        ncols = 4 if self.dtype_name == "int8" else 3
        # one fancy index per batch replaces B lookups of the index entries
        self._entry_mat = np.array(
            [e[:ncols] for e in self._index.values()], np.int64).reshape(
            len(self._index), ncols)
        self._row_of = {n: i for i, n in enumerate(self._index)}

    def entry_arrays(self, names):
        """(offs, rows, cols[, soffs]) int64 arrays for a batch of names."""
        rows = np.fromiter((self._row_of[n] for n in names), np.int64, len(names))
        return self._entry_mat[rows].T

    def lengths_for(self, names) -> np.ndarray:
        return self.entry_arrays(names)[1]

    def get(self, clip: str) -> np.ndarray:
        """float32 [T, D]: bf16 widened, int8 dequantised."""
        raw = self.get_raw(clip)
        if self.dtype_name == "bfloat16":
            return bf16_to_f32(raw)
        if self._scales is not None:
            return raw.astype(np.float32) * self.scales_for(clip)[None, :]
        return raw

    def get_raw(self, clip: str) -> np.ndarray:
        """The payload as stored: f32, bf16 bit patterns or int8 codes."""
        off, rows, cols = self._index[clip][:3]
        return np.asarray(self._blob[off: off + rows * cols]).reshape(rows, cols)

    def scales_for(self, clip: str) -> np.ndarray:
        """[cols] f32 per-channel scales of an int8 store (a view)."""
        _, _, cols, soff = self._index[clip][:4]
        return np.asarray(self._scales[soff: soff + cols])

    def scales_matrix(self):
        """[n_clips, dim] view of the scale sidecar when every clip has the
        same channel count; None for other stores or ragged channels."""
        if self._scales is None:
            return None
        if self._scales_mat is None:
            cols = {e[2] for e in self._index.values()}
            if len(cols) == 1 and self._scales.size:
                self._scales_mat = np.asarray(self._scales).reshape(-1, cols.pop())
        return self._scales_mat

    def length_of(self, clip: str) -> int:
        return self._index[clip][1]

    @property
    def dim(self) -> int:
        return next(iter(self._index.values()))[2]

    def __contains__(self, clip: str) -> bool:
        return clip in self._index


def _pool_into(raw: np.ndarray, bucket: int, dtype_name: str) -> np.ndarray:
    """An overlong clip mean-pooled into `bucket` frames in f32, then cast
    back to the payload: bf16 to nearest even, int8 toward zero."""
    wide = bf16_to_f32(raw) if dtype_name == "bfloat16" else raw.astype(np.float32)
    pooled = mapping_feature(wide, bucket)
    return bf16_bits(pooled) if dtype_name == "bfloat16" else pooled.astype(payload_dtype(dtype_name))


def fill_batch_from_packed(src: PackedSource, names, bucket: int, dim: Optional[int] = None,
                           out=None, prev_lengths: Optional[np.ndarray] = None):
    """[B, bucket, dim] batch of the store's payload, and the [B] int64
    lengths: each clip zero-padded to `bucket`, or mean-pooled into it when
    longer (collate.mapping_feature's semantics, summed in f32 and scaled
    by 1 / pool), by the C++ fill (``native.fill_batch_packed``; ``out``
    and ``prev_lengths`` as there)."""
    dim = dim or src.dim
    return native.fill_batch_packed(src.bin_path, tuple(src.entry_arrays(names)[:3]), bucket,
                                    dim, src.dtype_name, out=out, prev_lengths=prev_lengths)


def fill_batch_from_packed_plain(src: PackedSource, names, bucket: int,
                                 dim: Optional[int] = None,
                                 alloc: Optional[Callable[[tuple, np.dtype], np.ndarray]] = None):
    """``fill_batch_from_packed``'s plain numpy version: the same batch and
    lengths, an overlong f32 clip averaged by numpy's mean (so its pooled
    rows may differ from the C++ fill's in the last bit). ``alloc(shape,
    dtype)`` returns the zeroed buffer (e.g. a view of page-locked memory)."""
    dim = dim or src.dim
    shape = (len(names), bucket, dim)
    out = alloc(shape, src.payload_dtype) if alloc else np.zeros(shape, src.payload_dtype)
    lengths = np.zeros((len(names),), np.int64)
    for i, n in enumerate(names):
        raw = src.get_raw(n)
        feat = _pool_into(raw, bucket, src.dtype_name) if len(raw) > bucket else raw
        out[i, : len(feat), : feat.shape[1]] = feat
        lengths[i] = len(feat)
    return out, lengths


def batch_scales(src: PackedSource, names, dim: Optional[int] = None) -> np.ndarray:
    """[B, dim] f32 per-clip per-channel scales of an int8 store: one row
    gather when every clip has `dim` channels, else a loop."""
    dim = dim or src.dim
    mat = src.scales_matrix()
    if mat is not None and mat.shape[1] == dim:
        rows = np.fromiter((src._index[n][3] for n in names), np.int64, len(names)) // dim
        return mat[rows]
    out = np.zeros((len(names), dim), np.float32)
    for i, n in enumerate(names):
        s = src.scales_for(n)
        out[i, : len(s)] = s
    return out


def main(argv=None) -> int:
    """The ``pack`` stage of cli.extract: prints the store's prefix."""
    import argparse

    p = argparse.ArgumentParser(prog="cli.extract pack")
    p.add_argument("--src_dir", required=True, help="a directory of {clip}.npy [T, D]")
    p.add_argument("--out_prefix", required=True,
                   help="writes {out_prefix}.bin, .json (and .scales.bin for int8)")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16", "int8"),
                   help="payload dtype: bfloat16 halves the bytes (and runs the fusion "
                        "net's bf16 streams), int8 halves them again (per-clip "
                        "per-channel scales, dequantised on the device)")
    a = p.parse_args(argv)
    print(pack_features(a.src_dir, a.out_prefix, dtype=a.dtype))
    return 0
