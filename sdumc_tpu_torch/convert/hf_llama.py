"""An HF-format LLaMA / Vicuna directory -> the port's LlamaForCausalLM (or
its LlamaModel trunk alone, which the text stage runs).

The port of ``sdumc_tpu/convert/hf_llama.py`` without ``transformers``:
``config.json`` is read with ``json`` and the weights through
``convert/safetensors_io.py`` (``pytorch_model.bin`` with ``torch.load``,
``model.safetensors`` with the port's own reader, or the shards that either's
index maps; the ``safetensors`` package is not needed). The model is built on the meta
device and loaded with ``assign=True``; each tensor is cast to its dtype as
it is read (the fp16 checkpoint to bf16, norm scales to f32, as JAX keeps
them) and moved to the target device at once, so a 7B load never holds an
f32 copy or the whole checkpoint on the host. Given a model axis (``--tp
N``), each rank keeps only its slice of every split tensor as it is read
(``parallel/sharding.py``): no rank holds the whole checkpoint on its card.
Given a stage axis (``parallel/pipeline.py``), each stage reads only its
layers' keys, the embedding and the final norm.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Iterator, Mapping, Optional, Tuple

import torch

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.llama import (LlamaConfig, LlamaModel, model_from_state_dict,
                                          tp_model_from_state_dict)
from sdumc_tpu_torch.ops.quant import quantize_params
from sdumc_tpu_torch.parallel import pipeline, sharding

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


def target_dtype(key: str, dtype) -> torch.dtype:
    """Norm scales stay f32 (JAX keeps them f32 and applies them in f32);
    every other weight takes the model dtype."""
    return torch.float32 if key.endswith("norm.weight") else dtype


def iter_state_dict(model_dir: str, dtype=torch.bfloat16, device="cpu", prefix: str = "",
                    part: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                    keep: Optional[Callable[[str], bool]] = None
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every weight whose key starts with ``prefix`` (the
    key given without it), one shard at a time, each cast and moved as it
    is read. ``keep(key)``, if given, says which keys are read at all (a
    stage's). ``part(key, tensor)``, if given, picks what is kept of each
    tensor (a rank's slice) before the cast and the move: only that slice
    is read from the mapped file and reaches the device."""
    for path in safetensors_io.weight_files(model_dir):
        shard = safetensors_io.load_weight_file(path)
        for key in list(shard):
            if (key.endswith(IGNORED_SUFFIXES) or not key.startswith(prefix)
                    or (keep is not None and not keep(key[len(prefix):]))):
                continue
            t = shard[key] if part is None else part(key[len(prefix):], shard[key])
            yield key[len(prefix):], t.to(device=device, dtype=target_dtype(key, dtype))
        del shard


def _read_config(model_dir: str, dtype) -> LlamaConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf(json.load(f), dtype)


def _rank_state_dict(model_dir: str, cfg: LlamaConfig, dtype, device, prefix: str, axis):
    """(rank's state dict, layout): each tensor's slice along its
    ``llama_specs`` dim, cut before it is moved. Rank 0 prints
    ``tp_sharding_summary`` of the whole checkpoint."""
    specs, whole = {}, {}

    def part(key: str, t: torch.Tensor) -> torch.Tensor:
        specs[key] = sharding.llama_specs({key: t.shape}, cfg, axis.world)[key]
        whole[key] = torch.empty(t.shape, dtype=target_dtype(key, dtype), device="meta")
        return sharding.rank_part(t, specs[key], axis.rank, axis.world)

    sd = dict(iter_state_dict(model_dir, dtype, device, prefix, part))
    if axis.rank == 0:
        print(sharding.tp_sharding_summary(whole, specs), flush=True)
    return sd, specs


def load_hf_llama_trunk(model_dir: str, device="cpu", dtype=torch.bfloat16, axis=None,
                        stage=None):
    """(LlamaConfig, LlamaModel in eval mode on ``device``): the decoder
    trunk of an HF-format directory (the ``model.*`` weights); ``lm_head``
    is never read onto the device. ``axis`` (a ``parallel.ModelAxis`` of
    world > 1): the rank's tensor-parallel trunk, of which only the rank's
    slices are read. ``stage`` (the stage axis of ``parallel.pipeline``, of
    world > 1): the stage's trunk (``pipeline.stage_model_from_state_dict``),
    of which only the stage's layers, the embedding and the final norm are
    read. Raises as ``load_hf_llama`` does."""
    cfg = _read_config(model_dir, dtype)
    try:
        if axis is not None and axis.world > 1:
            sd, specs = _rank_state_dict(model_dir, cfg, dtype, device, "model.", axis)
            return cfg, tp_model_from_state_dict(cfg, sd, specs, axis, trunk=True)
        if stage is not None and stage.world > 1:
            layers = pipeline.stage_layers(cfg.num_layers, stage)
            sd = dict(iter_state_dict(model_dir, dtype, device, prefix="model.",
                                      keep=lambda key: pipeline.in_stage(key, layers)))
            return cfg, pipeline.stage_model_from_state_dict(cfg, sd, stage)
        sd = dict(iter_state_dict(model_dir, dtype, device, prefix="model."))
        with torch.device("meta"):
            trunk = LlamaModel(cfg)
        trunk.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise KeyError(f"{model_dir}: {e}") from e
    return cfg, trunk.eval()


def load_hf_llama(model_dir: str, device="cpu", dtype=torch.bfloat16,
                  quant: Optional[str] = None, kv_quant: Optional[str] = None, axis=None):
    """(LlamaConfig, LlamaForCausalLM in eval mode on ``device``) from an
    HF-format directory. ``quant`` ("int8" / "w8a8") quantizes the loaded
    weights on ``device`` one tensor at a time, each float tensor released
    as its int8 codes are made; ``kv_quant`` ("int8") sets the KV cache.
    ``axis`` (a ``parallel.ModelAxis`` of world > 1): the rank's
    tensor-parallel model (``models.llama.tp_model_from_state_dict``), of
    which only the rank's slices are read; it takes no ``quant``. Raises if
    a weight of the model is missing or the checkpoint holds a key the
    model does not know."""
    cfg = dataclasses.replace(_read_config(model_dir, dtype), quant=quant, kv_quant=kv_quant)
    try:
        if axis is not None and axis.world > 1:
            if quant:
                raise ValueError("a quantized model is not split over ranks (as in JAX)")
            sd, specs = _rank_state_dict(model_dir, cfg, dtype, device, "", axis)
            return cfg, tp_model_from_state_dict(cfg, sd, specs, axis)
        sd = dict(iter_state_dict(model_dir, dtype, device))
        if quant:
            sd = quantize_params(sd, quant)
        return cfg, model_from_state_dict(cfg, sd)
    except RuntimeError as e:
        raise KeyError(f"{model_dir}: {e}") from e
