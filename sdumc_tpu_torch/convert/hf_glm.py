"""A GLM directory of either lineage -> the port's GlmModel.

The port of ``sdumc_tpu/convert/hf_glm.py`` without ``transformers`` or
``safetensors`` (``convert/hf_text.py``), dispatching as ``load_hf_glm``
does on ``config.json``'s ``model_type``:

* ``chatglm`` (THUDM chatglm2, whose modeling code needs
  trust_remote_code): the config from its own fields (``padded_vocab_size``,
  ``ffn_hidden_size``, ``kv_channels``, ``multi_query_group_num``,
  ``rope_ratio``, ...), the tensors renamed and split into the HF-native
  layout: the fused ``self_attention.query_key_value`` splits
  [H * hd | KV * hd | KV * hd] in order, ``mlp.dense_h_to_4h`` is the fused
  gate | up, ``self_attention.dense`` the output projection; the
  ``output_layer`` (lm head) and rotary buffers are dropped;
* anything else: HF's native ``GlmModel`` (glm / glm-4 lineage), whose
  names are the port's (``model.`` stripped, ``lm_head`` dropped).

The tensors come, as JAX reads them, from every ``*.safetensors`` in the
directory (sorted), else the shards of ``pytorch_model.bin.index.json``,
else ``pytorch_model.bin``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Mapping, Optional

import torch

from sdumc_tpu_torch.convert import hf_text
from sdumc_tpu_torch.models.glm import GlmConfig, GlmModel

_CHATGLM_LAYERS = "transformer.encoder.layers."
_CHATGLM_RENAMES = {"self_attention.dense.weight": "self_attn.o_proj.weight",
                    "mlp.dense_h_to_4h.weight": "mlp.gate_up_proj.weight",
                    "mlp.dense_4h_to_h.weight": "mlp.down_proj.weight",
                    "input_layernorm.weight": "input_layernorm.weight",
                    "post_attention_layernorm.weight": "post_attention_layernorm.weight"}


def config_from_hf(m: Mapping) -> GlmConfig:
    """GlmConfig of an HF-native GlmModel ``config.json`` (transformers'
    defaults for what it leaves out)."""
    return GlmConfig(
        vocab_size=m.get("vocab_size", 151552),
        hidden_size=m.get("hidden_size", 4096),
        intermediate_size=m.get("intermediate_size", 13696),
        num_layers=m.get("num_hidden_layers", 40),
        num_heads=m.get("num_attention_heads", 32),
        num_kv_heads=m.get("num_key_value_heads", 2),
        head_dim=m.get("head_dim") or m.get("hidden_size", 4096) // m.get("num_attention_heads", 32),
        partial_rotary_factor=m.get("partial_rotary_factor", 0.5),
        rope_theta=m.get("rope_theta", 10000.0),
        rms_eps=m.get("rms_norm_eps", 1.5625e-07),
        attention_bias=m.get("attention_bias", True),
    )


def config_from_chatglm(raw: Mapping) -> GlmConfig:
    """GlmConfig of a THUDM chatglm2 ``config.json`` (model_type
    ``chatglm``), mapped field by field as JAX maps it."""
    n_heads = raw["num_attention_heads"]
    return GlmConfig(
        vocab_size=raw.get("padded_vocab_size") or raw["vocab_size"],
        hidden_size=raw["hidden_size"],
        intermediate_size=raw["ffn_hidden_size"],
        num_layers=raw["num_layers"],
        num_heads=n_heads,
        num_kv_heads=(raw["multi_query_group_num"] if raw.get("multi_query_attention")
                      else n_heads),
        head_dim=raw.get("kv_channels") or raw["hidden_size"] // n_heads,
        partial_rotary_factor=0.5,
        rope_theta=10000.0 * raw.get("rope_ratio", 1.0),
        rms_eps=raw.get("layernorm_epsilon", 1e-5),
        attention_bias=raw.get("add_qkv_bias", True),
    )


def weight_files(model_dir: str) -> List[str]:
    """The checkpoint's tensor files in JAX's order of preference."""
    st = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st:
        return st
    index = os.path.join(model_dir, "pytorch_model.bin.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(model_dir, s) for s in shards]
    return [os.path.join(model_dir, "pytorch_model.bin")]


def _chatglm_key(key: str) -> Optional[str]:
    """The HF-native key of a chatglm2 tensor (its fused QKV keeps its
    name, split later), or None for the lm head and buffers."""
    if key == "transformer.embedding.word_embeddings.weight":
        return "embed_tokens.weight"
    if key == "transformer.encoder.final_layernorm.weight":
        return "norm.weight"
    if key.startswith(_CHATGLM_LAYERS):
        i, sub = key[len(_CHATGLM_LAYERS):].split(".", 1)
        if sub.startswith("self_attention.query_key_value."):
            return f"layers.{i}.{sub}"
        if sub in _CHATGLM_RENAMES:
            return f"layers.{i}.{_CHATGLM_RENAMES[sub]}"
    return None


def chatglm_to_hf_names(sd: Dict[str, torch.Tensor], cfg: GlmConfig) -> Dict[str, torch.Tensor]:
    """A chatglm2 state dict (keys already through ``_chatglm_key``) with
    each fused QKV split into q_proj / k_proj / v_proj."""
    q_sz, kv_sz = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out = {}
    for key, value in sd.items():
        if ".self_attention.query_key_value." in key:
            pre, kind = key.split(".self_attention.query_key_value.")
            for name, part in zip(("q_proj", "k_proj", "v_proj"),
                                  torch.split(value, [q_sz, kv_sz, kv_sz], dim=0)):
                out[f"{pre}.self_attn.{name}.{kind}"] = part.contiguous()
        else:
            out[key] = value
    return out


def load_hf_glm(model_dir: str, device="cpu"):
    """(GlmConfig, GlmModel in eval mode on ``device``), f32, from a
    chatglm2 or an HF-native GLM directory."""
    raw = hf_text.read_config(model_dir)
    files = weight_files(model_dir)
    if raw.get("model_type") == "chatglm":
        cfg = config_from_chatglm(raw)
        sd = chatglm_to_hf_names(hf_text.read_weights(files, _chatglm_key, device), cfg)
        return cfg, hf_text.build(GlmModel, cfg, sd, model_dir)
    cfg = config_from_hf(raw)
    return hf_text.load(model_dir, cfg, GlmModel,
                        hf_text.renamer(("model.",), ("embed_tokens.", "layers.", "norm.")),
                        device, files)
