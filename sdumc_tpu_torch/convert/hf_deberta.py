"""An HF DebertaModel (v1) directory -> the port's DebertaModel.

The port of ``sdumc_tpu/convert/hf_deberta.py`` without ``transformers``
(``convert/hf_text.py``): the weights load under HF's names (``in_proj``
[3D, D] keeps HF's per-head q, k, v order), ``deberta.`` stripped, heads
dropped. ``pos_att_type`` may be a list or HF's ``"c2p|p2c"`` string;
``max_relative_positions`` below 1 means ``max_position_embeddings``.

``config.json``'s ``model_type`` must be ``deberta``: a DeBERTa-v2 / v3
directory (``deberta-v2``, e.g. microsoft/deberta-v3-large) raises. Its
attention has other weights (``query_proj``, ``key_proj``, ``value_proj``,
a layer-normed relative table); JAX's loader reads it with
``transformers.DebertaModel``, which loads with those weights missing and
initialised at random, and reports no error.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import hf_text
from sdumc_tpu_torch.models.deberta import DebertaConfig, DebertaModel


def pos_att_types(value) -> tuple:
    if isinstance(value, str):
        return tuple(x.strip() for x in value.lower().split("|") if x.strip())
    return tuple(value or ())


def config_from_hf(m: Mapping) -> DebertaConfig:
    if m.get("model_type", "deberta") != "deberta":
        raise ValueError(f"model_type {m.get('model_type')!r}: the DeBERTa loader reads v1 "
                         "(model_type 'deberta') only; DeBERTa-v2/v3 is another architecture")
    max_pos = m.get("max_position_embeddings", 512)
    max_rel = m.get("max_relative_positions", -1)
    return DebertaConfig(
        vocab_size=m.get("vocab_size", 50265),
        hidden_size=m.get("hidden_size", 768),
        num_layers=m.get("num_hidden_layers", 12),
        num_heads=m.get("num_attention_heads", 12),
        intermediate_size=m.get("intermediate_size", 3072),
        max_position_embeddings=max_pos,
        max_relative_positions=max_rel if max_rel >= 1 else max_pos,
        type_vocab_size=m.get("type_vocab_size", 0),
        position_biased_input=m.get("position_biased_input", True),
        pos_att_type=pos_att_types(m.get("pos_att_type")),
        layer_norm_eps=m.get("layer_norm_eps", 1e-7),
    )


def load_hf_deberta(model_dir: str, device="cpu"):
    """(DebertaConfig, DebertaModel in eval mode on ``device``), f32;
    raises on a DeBERTa-v2 directory."""
    cfg = config_from_hf(hf_text.read_config(model_dir))
    return hf_text.load(model_dir, cfg, DebertaModel,
                        hf_text.renamer(("deberta.",), ("embeddings.", "encoder.")), device)
