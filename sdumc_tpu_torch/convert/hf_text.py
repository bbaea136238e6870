"""What the text families' HF loaders share (``convert/hf_{bert,albert,
deberta,bloom,glm}.py``): ``config.json`` read with ``json``, the weights
through ``convert/safetensors_io.py`` (neither ``transformers`` nor
``safetensors`` is needed), each tensor renamed to the port's key, widened
to f32 and moved to the target device as it is read (JAX's loaders widen
every tensor to f32 too), then assigned into the model built on the meta
device.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from sdumc_tpu_torch.convert import safetensors_io

# buffers that some checkpoints hold and the port computes
IGNORED_SUFFIXES = ("position_ids", "token_type_ids")


def read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def renamer(prefixes: Tuple[str, ...], keep: Tuple[str, ...]) -> Callable[[str], Optional[str]]:
    """The key map of a base model: a checkpoint with a head keeps the base
    model under one of ``prefixes`` (HF's ``base_model_prefix``), which is
    stripped; keys outside ``keep`` (heads, the pooler) and computed buffers
    are dropped; TF-era ``LayerNorm.gamma`` / ``beta`` become ``weight`` /
    ``bias``, as ``from_pretrained`` renames them."""
    def rename(key: str) -> Optional[str]:
        key = next((key[len(p):] for p in prefixes if key.startswith(p)), key)
        if not key.startswith(keep) or key.endswith(IGNORED_SUFFIXES):
            return None
        if key.endswith("LayerNorm.gamma"):
            return key[:-len("gamma")] + "weight"
        if key.endswith("LayerNorm.beta"):
            return key[:-len("beta")] + "bias"
        return key
    return rename


def read_weights(files: Iterable[str], rename: Callable[[str], Optional[str]],
                 device="cpu") -> Dict[str, torch.Tensor]:
    """{port key: f32 tensor on ``device``} of every tensor in ``files`` that
    ``rename`` maps (None drops it), one file at a time."""
    out: Dict[str, torch.Tensor] = {}
    for path in files:
        shard = safetensors_io.load_weight_file(path)
        for key in list(shard):
            new = rename(key)
            if new is not None:
                out[new] = shard[key].to(device=device, dtype=torch.float32)
        del shard
    return out


def build(model_cls, cfg, state_dict: Dict[str, torch.Tensor], source: str):
    """``model_cls(cfg)`` built on the meta device with ``state_dict``'s
    tensors assigned, in eval mode; raises naming ``source`` on a missing or
    unknown key."""
    with torch.device("meta"):
        model = model_cls(cfg)
    return safetensors_io.assign_weights(model, state_dict, source)


def load(model_dir: str, cfg, model_cls, rename, device="cpu",
         files: Optional[List[str]] = None):
    """(cfg, model in eval mode on ``device``) from the directory's weight
    files (``safetensors_io.weight_files`` unless ``files`` is given)."""
    files = files if files is not None else safetensors_io.weight_files(model_dir)
    return cfg, build(model_cls, cfg, read_weights(files, rename, device), model_dir)
