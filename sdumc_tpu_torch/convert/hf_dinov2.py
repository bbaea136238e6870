"""An HF-format DINOv2 directory (``facebook/dinov2-base``) -> the port's
Dinov2Model, without ``transformers`` (JAX calls
``Dinov2Model.from_pretrained``, ``sdumc_tpu/convert/hf_dinov2.py``).

``config.json`` is read with ``json``, HF ``Dinov2Config``'s defaults
filling the fields it omits; the weights through
``convert/safetensors_io.py``. A ``dinov2.`` prefix (a checkpoint of a
model with a head) is stripped and the head's keys dropped, as
``from_pretrained`` does; so is ``embeddings.mask_token``, which only
masked pretraining reads.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.dinov2 import Dinov2Config, Dinov2Model

# HF Dinov2Config's defaults (transformers 4.57)
HF_DEFAULTS = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, mlp_ratio=4,
                   image_size=224, patch_size=14, layer_norm_eps=1e-6, use_swiglu_ffn=False)
TRUNK = ("embeddings.", "encoder.", "layernorm.")
IGNORED = ("embeddings.mask_token",)


def config_from_hf(mapping: Mapping) -> Dinov2Config:
    f = {**HF_DEFAULTS, **mapping}
    return Dinov2Config(
        hidden_size=f["hidden_size"], num_layers=f["num_hidden_layers"],
        num_heads=f["num_attention_heads"], mlp_ratio=f["mlp_ratio"],
        image_size=f["image_size"], patch_size=f["patch_size"],
        layer_norm_eps=f["layer_norm_eps"], use_swiglu_ffn=f["use_swiglu_ffn"])


def load_hf_dinov2(model_dir: str):
    """(Dinov2Config, Dinov2Model in eval mode on the CPU)."""
    return safetensors_io.load_hf_model(model_dir, config_from_hf, Dinov2Model, "dinov2.", TRUNK,
                                        IGNORED)
