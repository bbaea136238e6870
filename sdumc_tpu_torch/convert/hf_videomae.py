"""An HF-format VideoMAE directory -> the port's VideoMAEModel, without
``transformers`` (JAX calls ``VideoMAEModel.from_pretrained``,
``sdumc_tpu/convert/hf_videomae.py``).

``config.json`` is read with ``json``, HF ``VideoMAEConfig``'s defaults
filling the fields it omits. ``MCG-NJU/videomae-base`` is a
``VideoMAEForPreTraining`` checkpoint: its encoder sits under
``videomae.``, beside the pretraining decoder (``decoder.*``,
``encoder_to_decoder``, ``mask_token``), which the loader drops, as
``from_pretrained`` does. The sinusoid table is no weight in HF and is
rebuilt by the model; k's zero bias is no weight either.
"""

from __future__ import annotations

from typing import Mapping

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.videomae import VideoMAEConfig, VideoMAEModel

# HF VideoMAEConfig's defaults (transformers 4.57)
HF_DEFAULTS = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, image_size=224, patch_size=16, num_frames=16,
                   tubelet_size=2, layer_norm_eps=1e-12, qkv_bias=True, use_mean_pooling=True)
TRUNK = ("embeddings.", "encoder.", "layernorm.")


def config_from_hf(mapping: Mapping) -> VideoMAEConfig:
    f = {**HF_DEFAULTS, **mapping}
    return VideoMAEConfig(
        hidden_size=f["hidden_size"], num_layers=f["num_hidden_layers"],
        num_heads=f["num_attention_heads"], intermediate_size=f["intermediate_size"],
        image_size=f["image_size"], patch_size=f["patch_size"], num_frames=f["num_frames"],
        tubelet_size=f["tubelet_size"], layer_norm_eps=f["layer_norm_eps"],
        qkv_bias=f["qkv_bias"], use_mean_pooling=f["use_mean_pooling"])


def load_hf_videomae(model_dir: str):
    """(VideoMAEConfig, VideoMAEModel in eval mode on the CPU)."""
    return safetensors_io.load_hf_model(model_dir, config_from_hf, VideoMAEModel, "videomae.",
                                        TRUNK)
