"""An HF BloomModel directory (bloom-7b1) -> the port's BloomModel.

The port of ``sdumc_tpu/convert/hf_bloom.py`` without ``transformers``
(``convert/hf_text.py``): the weights load under HF's names (the fused
``query_key_value`` keeps HF's per-head q, k, v order), ``transformer.``
stripped, ``lm_head`` dropped. ``n_layer`` / ``n_head`` may also be
written ``num_hidden_layers`` / ``num_attention_heads``. A config with
``apply_residual_connection_post_layernorm`` raises: no published BLOOM
sets it, and the port's blocks (as JAX's) add the residual before the norm.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import hf_text
from sdumc_tpu_torch.models.bloom import BloomConfig, BloomModel


def config_from_hf(m: Mapping) -> BloomConfig:
    if m.get("apply_residual_connection_post_layernorm"):
        raise NotImplementedError("BLOOM with apply_residual_connection_post_layernorm")
    return BloomConfig(
        vocab_size=m.get("vocab_size", 250880),
        hidden_size=m.get("hidden_size", 64),
        num_layers=m.get("n_layer", m.get("num_hidden_layers", 2)),
        num_heads=m.get("n_head", m.get("num_attention_heads", 8)),
        layer_norm_eps=m.get("layer_norm_epsilon", 1e-5),
    )


def load_hf_bloom(model_dir: str, device="cpu"):
    """(BloomConfig, BloomModel in eval mode on ``device``), f32."""
    cfg = config_from_hf(hf_text.read_config(model_dir))
    return hf_text.load(model_dir, cfg, BloomModel,
                        hf_text.renamer(("transformer.",),
                                        ("word_embeddings", "h.", "ln_f.")), device)
