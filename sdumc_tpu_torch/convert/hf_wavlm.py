"""An HF-format WavLM / wav2vec2 / HuBERT directory -> the port's WavLMModel.

Reads ``config.json`` with ``json`` and the weights through
``convert/safetensors_io.py`` (``pytorch_model.bin`` with ``torch.load``,
``model.safetensors`` with the port's own reader, or either's shards); neither ``transformers`` nor
``safetensors`` is imported. The port's submodules carry HF's
state_dict names, so the weights load as a state dict; the positional
conv's weight norm (g * v / ||v||, torch weight_norm dim=2) is folded into
one effective weight, since extraction runs the encoder frozen.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping

import torch

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

POS_CONV = "encoder.pos_conv_embed.conv"
# HF keys the port has no module for (SpecAugment's mask embedding)
IGNORED = ("masked_spec_embed",)


def config_from_hf(mapping: Mapping) -> WavLMConfig:
    """A ``config.json`` dict -> WavLMConfig. ``num_buckets`` present means
    WavLM; absent means wav2vec2 / HuBERT (no relative position bias)."""
    is_wavlm = "num_buckets" in mapping
    return WavLMConfig(
        hidden_size=mapping["hidden_size"],
        num_layers=mapping["num_hidden_layers"],
        num_heads=mapping["num_attention_heads"],
        intermediate_size=mapping["intermediate_size"],
        conv_dim=tuple(mapping["conv_dim"]),
        conv_kernel=tuple(mapping["conv_kernel"]),
        conv_stride=tuple(mapping["conv_stride"]),
        conv_bias=mapping["conv_bias"],
        feat_extract_norm=mapping["feat_extract_norm"],
        do_stable_layer_norm=mapping["do_stable_layer_norm"],
        num_conv_pos_embeddings=mapping["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=mapping["num_conv_pos_embedding_groups"],
        num_buckets=mapping.get("num_buckets", 320),
        max_bucket_distance=mapping.get("max_bucket_distance", 800),
        layer_norm_eps=mapping["layer_norm_eps"],
        use_rel_pos_bias=is_wavlm,
    )


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over dims (0, 1) of v [out, in/groups, k]."""
    norm = v.float().pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    return g.float() * v.float() / norm.clamp(min=1e-12)


def hf_state_dict_to_port(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF's state dict -> the port's: the positional conv's weight norm
    folded (either key style), unused keys dropped."""
    sd = {key: val for key, val in state_dict.items() if key not in IGNORED}
    for g_key, v_key in ((f"{POS_CONV}.parametrizations.weight.original0",
                          f"{POS_CONV}.parametrizations.weight.original1"),
                         (f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v")):
        if g_key in sd:
            sd[f"{POS_CONV}.weight"] = fold_weight_norm(sd.pop(g_key), sd.pop(v_key))
    return sd


def load_hf_wavlm(model_dir: str, **overrides):
    """(WavLMConfig, WavLMModel in eval mode on the CPU) from an HF-format
    directory; ``overrides`` replace config fields (e.g. attention_impl).
    Raises if a weight of the model is missing or the checkpoint holds a
    key the model does not know."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = dataclasses.replace(config_from_hf(json.load(f)), **overrides)
    with torch.device("meta"):                     # no init work: every weight is loaded
        model = WavLMModel(cfg)
    sd = {k: v.float() for k, v in hf_state_dict_to_port(safetensors_io.load_hf_weights(model_dir)).items()}
    result = model.load_state_dict(sd, strict=False, assign=True)
    if result.missing_keys or result.unexpected_keys:
        raise KeyError(f"{model_dir}: missing {result.missing_keys}, "
                       f"unexpected {result.unexpected_keys}")
    return cfg, model.eval()
