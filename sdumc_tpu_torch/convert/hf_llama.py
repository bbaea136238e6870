"""An HF-format LLaMA / Vicuna directory -> the port's LlamaForCausalLM (or
its LlamaModel trunk alone, which the text stage runs).

The port of ``sdumc_tpu/convert/hf_llama.py`` without ``transformers``:
``config.json`` is read with ``json`` and the weights with ``torch.load``
(``pytorch_model.bin``, or the shards ``pytorch_model-0000k-of-0000n.bin``
that ``pytorch_model.bin.index.json`` maps) or with ``safetensors``
(``model.safetensors`` and its shards), which raises clearly where that
package is missing. The model is built on the meta device and loaded with
``assign=True``; each tensor is cast to its dtype as it is read (the fp16
checkpoint to bf16, norm scales to f32, as JAX keeps them) and moved to the
target device at once, so a 7B load never holds an f32 copy or the whole
checkpoint on the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Mapping, Optional, Tuple

import torch

from sdumc_tpu_torch.models.llama import LlamaConfig, LlamaModel, model_from_state_dict
from sdumc_tpu_torch.ops.quant import quantize_params

# keys of older HF checkpoints that the port computes instead of loading
IGNORED_SUFFIXES = ("rotary_emb.inv_freq",)


def config_from_hf(mapping: Mapping, dtype=torch.bfloat16) -> LlamaConfig:
    """A ``config.json`` dict -> LlamaConfig in ``dtype`` (bf16, as JAX's
    ``config_from_hf`` sets it)."""
    return LlamaConfig(
        vocab_size=mapping["vocab_size"],
        hidden_size=mapping["hidden_size"],
        intermediate_size=mapping["intermediate_size"],
        num_layers=mapping["num_hidden_layers"],
        num_heads=mapping["num_attention_heads"],
        num_kv_heads=mapping.get("num_key_value_heads"),
        rope_theta=mapping.get("rope_theta", 10000.0),
        rms_eps=mapping["rms_norm_eps"],
        max_position_embeddings=mapping["max_position_embeddings"],
        dtype=dtype,
    )


def _load_file(path: str) -> Mapping[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"{path} needs the safetensors package, which is not "
                               "installed; save the checkpoint as pytorch_model*.bin") from e
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def weight_files(model_dir: str):
    """The weight files of an HF directory, in shard order."""
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


def target_dtype(key: str, dtype) -> torch.dtype:
    """Norm scales stay f32 (JAX keeps them f32 and applies them in f32);
    every other weight takes the model dtype."""
    return torch.float32 if key.endswith("norm.weight") else dtype


def iter_state_dict(model_dir: str, dtype=torch.bfloat16, device="cpu", prefix: str = ""
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every weight whose key starts with ``prefix`` (the
    key given without it), one shard at a time, each cast and moved as it
    is read."""
    for path in weight_files(model_dir):
        shard = _load_file(path)
        for key in list(shard):
            if key.endswith(IGNORED_SUFFIXES) or not key.startswith(prefix):
                continue
            yield key[len(prefix):], shard[key].to(device=device, dtype=target_dtype(key, dtype))
        del shard


def _read_config(model_dir: str, dtype) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), dtype)


def load_hf_llama_trunk(model_dir: str, device="cpu", dtype=torch.bfloat16):
    """(LlamaConfig, LlamaModel in eval mode on ``device``): the decoder
    trunk of an HF-format directory (the ``model.*`` weights); ``lm_head``
    is never read onto the device. Raises as ``load_hf_llama`` does."""
    cfg = _read_config(model_dir, dtype)
    sd = dict(iter_state_dict(model_dir, dtype, device, prefix="model."))
    with torch.device("meta"):
        trunk = LlamaModel(cfg)
    try:
        trunk.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise KeyError(f"{model_dir}: {e}") from e
    return cfg, trunk.eval()


def load_hf_llama(model_dir: str, device="cpu", dtype=torch.bfloat16,
                  quant: Optional[str] = None, kv_quant: Optional[str] = None):
    """(LlamaConfig, LlamaForCausalLM in eval mode on ``device``) from an
    HF-format directory. ``quant`` ("int8" / "w8a8") quantizes the loaded
    weights on ``device`` one tensor at a time, each float tensor released
    as its int8 codes are made; ``kv_quant`` ("int8") sets the KV cache.
    Raises if a weight of the model is missing or the checkpoint holds a
    key the model does not know."""
    cfg = dataclasses.replace(_read_config(model_dir, dtype), quant=quant, kv_quant=kv_quant)
    sd = dict(iter_state_dict(model_dir, dtype, device))
    if quant:
        sd = quantize_params(sd, quant)
    try:
        return cfg, model_from_state_dict(cfg, sd)
    except RuntimeError as e:
        raise KeyError(f"{model_dir}: {e}") from e
