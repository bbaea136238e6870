"""An HF AlbertModel directory -> the port's AlbertModel (one shared layer
group, as the reference's albert-base/large/xxlarge and the Chinese
tiny/small checkpoints have).

The port of ``sdumc_tpu/convert/hf_albert.py`` without ``transformers``
(``convert/hf_text.py``): the weights load under HF's names, ``albert.``
stripped, the pooler and heads dropped. Fields that ``config.json`` leaves
out take transformers' ``AlbertConfig`` defaults. More than one hidden
group or inner group raises, as JAX's converter asserts.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import hf_text
from sdumc_tpu_torch.models.albert import AlbertConfig, AlbertModel


def config_from_hf(m: Mapping) -> AlbertConfig:
    for key in ("num_hidden_groups", "inner_group_num"):
        if m.get(key, 1) != 1:
            raise NotImplementedError(f"ALBERT with {key} = {m[key]}: only one shared layer "
                                      "group of one layer is supported")
    return AlbertConfig(
        vocab_size=m.get("vocab_size", 30000),
        embedding_size=m.get("embedding_size", 128),
        hidden_size=m.get("hidden_size", 4096),
        num_layers=m.get("num_hidden_layers", 12),
        num_heads=m.get("num_attention_heads", 64),
        intermediate_size=m.get("intermediate_size", 16384),
        max_position_embeddings=m.get("max_position_embeddings", 512),
        type_vocab_size=m.get("type_vocab_size", 2),
        layer_norm_eps=m.get("layer_norm_eps", 1e-12),
        hidden_act=m.get("hidden_act", "gelu_new"),
    )


def load_hf_albert(model_dir: str, device="cpu"):
    """(AlbertConfig, AlbertModel in eval mode on ``device``), f32."""
    cfg = config_from_hf(hf_text.read_config(model_dir))
    return hf_text.load(model_dir, cfg, AlbertModel,
                        hf_text.renamer(("albert.",), ("embeddings.", "encoder.")), device)
