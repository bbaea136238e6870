"""An HF-format CLIP directory -> the port's CLIPVisionTower, without
``transformers``.

JAX calls ``CLIPVisionModelWithProjection.from_pretrained``
(``sdumc_tpu/convert/hf_clip.py:77-83``); the port reads ``config.json``
with ``json`` and the weights through ``convert/safetensors_io.py``.
openai's checkpoints (``openai/clip-vit-large-patch14``) are whole
``CLIPModel``s: ``model_type`` "clip", the vision tower's fields nested in
``vision_config`` (``vision_config_dict`` in older files), often only
those that differ from HF's ``CLIPVisionConfig`` defaults, which fill the
rest, and ``projection_dim`` at the top level; their weights carry the
text tower too (``text_model.*``, ``text_projection``, ``logit_scale``),
which the loader skips. A stand-alone ``clip_vision_model`` directory
(``CLIPVisionModelWithProjection``'s) loads the same way.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.clip_vit import CLIPVisionConfig, CLIPVisionTower

# HF CLIPVisionConfig's defaults (transformers 4.57)
HF_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                   num_attention_heads=12, image_size=224, patch_size=32, projection_dim=512,
                   layer_norm_eps=1e-5, hidden_act="quick_gelu")
KEEP = ("vision_model.", "visual_projection.")
IGNORED = ("vision_model.embeddings.position_ids",)   # a buffer that older checkpoints saved


def config_from_hf(mapping: Mapping) -> CLIPVisionConfig:
    """A ``config.json`` dict (whole ``CLIPModel`` or vision tower alone) ->
    CLIPVisionConfig. A whole model's ``visual_projection`` is as wide as
    its top-level ``projection_dim`` (HF's ``CLIPModel`` builds it so), and
    a nested ``projection_dim`` is not read: transformers 4.57 writes HF's
    default 512 there whatever the top level says."""
    vision = dict(mapping)
    if mapping.get("model_type") == "clip":
        vision = dict(mapping.get("vision_config") or mapping.get("vision_config_dict") or {})
        vision["projection_dim"] = mapping.get("projection_dim", HF_DEFAULTS["projection_dim"])
    f = {**HF_DEFAULTS, **vision}
    return CLIPVisionConfig(
        hidden_size=f["hidden_size"], intermediate_size=f["intermediate_size"],
        num_layers=f["num_hidden_layers"], num_heads=f["num_attention_heads"],
        image_size=f["image_size"], patch_size=f["patch_size"],
        projection_dim=f["projection_dim"], layer_norm_eps=f["layer_norm_eps"],
        hidden_act=f["hidden_act"])


def load_hf_clip_vision(model_dir: str):
    """(CLIPVisionConfig, CLIPVisionTower in eval mode on the CPU) from an
    HF-format directory. Raises if a weight of the tower is missing or an
    unknown key sits among its tensors."""
    return safetensors_io.load_hf_model(model_dir, config_from_hf, CLIPVisionTower, "", KEEP,
                                        IGNORED)
