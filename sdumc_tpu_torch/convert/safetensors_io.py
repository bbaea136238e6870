"""``model.safetensors`` without the ``safetensors`` package.

The format: an 8-byte little-endian header length n, n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"``), then the raw little-endian buffers, the
offsets counted from the end of the header. ``load_file`` maps the file
copy-on-write and views each tensor in place (nothing is read until a
tensor is used); ``save_file`` writes the format, for seeded checkpoints.

``weight_files`` resolves an HF directory's weights (``pytorch_model.bin``,
``model.safetensors``, or the shards that either's index maps),
``load_weight_file`` reads one of them, and ``load_hf_weights`` all of
them into one dict; every HF loader of the port reads through these.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Mapping

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
NAMES = {dtype: name for name, dtype in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one .safetensors file, the tensors viewing a
    copy-on-write map of it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        if count * dtype.itemsize != end - begin or start + end > size:
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} that do not fit "
                             f"its dtype {info['dtype']} or the file")
        flat = (torch.frombuffer(buf, dtype=dtype, count=count, offset=start + begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def weight_files(model_dir: str) -> List[str]:
    """The weight files of an HF directory, in shard order:
    ``pytorch_model.bin`` or its shards, else ``model.safetensors`` or its
    shards."""
    for single, index in (("pytorch_model.bin", "pytorch_model.bin.index.json"),
                          ("model.safetensors", "model.safetensors.index.json")):
        if os.path.exists(os.path.join(model_dir, single)):
            return [os.path.join(model_dir, single)]
        if os.path.exists(os.path.join(model_dir, index)):
            with open(os.path.join(model_dir, index)) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(model_dir, s) for s in shards]
    raise FileNotFoundError(f"{model_dir} holds no pytorch_model.bin, model.safetensors or "
                            "sharded index of either")


def load_weight_file(path: str) -> Mapping[str, torch.Tensor]:
    """One weight file: .safetensors through ``load_file``, else
    ``torch.load`` (memory-mapped, weights only)."""
    if path.endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_hf_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF directory's weight files, in one dict."""
    out: Dict[str, torch.Tensor] = {}
    for path in weight_files(model_dir):
        out.update(load_weight_file(path))
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (contiguous copies, in name order) as one
    .safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)           # the data section starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
