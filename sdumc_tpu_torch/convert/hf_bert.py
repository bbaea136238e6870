"""An HF BertModel / RobertaModel directory (BERT, RoBERTa, MacBERT,
SimBERT) -> the port's BertModel.

The port of ``sdumc_tpu/convert/hf_bert.py`` without ``transformers``
(``convert/hf_text.py``). The port's modules carry HF's names, so the
weights load as they are: a checkpoint with a head keeps the encoder under
``bert.`` / ``roberta.``, which is stripped; the pooler and heads are
dropped. Fields that ``config.json`` leaves out take transformers'
defaults. RoBERTa (``model_type`` roberta, xlm-roberta, camembert) offsets
positions by ``pad_token_id + 1``, as JAX's ``config_from_hf`` does.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import hf_text
from sdumc_tpu_torch.models.bert import BertConfig, BertModel

ROBERTA_TYPES = ("roberta", "xlm-roberta", "camembert")


def config_from_hf(m: Mapping) -> BertConfig:
    is_roberta = m.get("model_type") in ROBERTA_TYPES
    pad = m.get("pad_token_id", 1 if is_roberta else 0)
    return BertConfig(
        vocab_size=m.get("vocab_size", 30522),
        hidden_size=m.get("hidden_size", 768),
        num_layers=m.get("num_hidden_layers", 12),
        num_heads=m.get("num_attention_heads", 12),
        intermediate_size=m.get("intermediate_size", 3072),
        max_position_embeddings=m.get("max_position_embeddings", 512),
        type_vocab_size=m.get("type_vocab_size", 2),
        layer_norm_eps=m.get("layer_norm_eps", 1e-12),
        position_offset=(pad or 1) + 1 if is_roberta else 0,
    )


def load_hf_bert(model_dir: str, device="cpu"):
    """(BertConfig, BertModel in eval mode on ``device``), f32."""
    cfg = config_from_hf(hf_text.read_config(model_dir))
    return hf_text.load(model_dir, cfg, BertModel,
                        hf_text.renamer(("bert.", "roberta."), ("embeddings.", "encoder.")),
                        device)
