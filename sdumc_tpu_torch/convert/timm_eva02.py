"""A timm EVA-02 checkpoint directory -> the port's Eva02Model, without
timm or ``safetensors`` (the port of ``sdumc_tpu/convert/timm_eva02.py``).

The tensors are read raw (every ``*.safetensors`` of the directory, else
``pytorch_model.bin`` or its shards), a ``model.`` prefix is stripped and
the encoder trunk kept: timm's ``eva02_base_patch14_224`` schema
(qkv_fused=False, swiglu_mlp=True, scale_mlp=True): ``cls_token``,
``pos_embed``, ``patch_embed.proj``, ``blocks.{i}.{norm1, attn.q_proj,
attn.k_proj (no bias), attn.v_proj, attn.proj, norm2, mlp.fc1_g,
mlp.fc1_x, mlp.norm, mlp.fc2}`` and ``fc_norm`` (a MIM export's final
``norm`` is taken as ``fc_norm``, as JAX takes it). timm's ``config.json``
carries no architecture fields, so the config is inferred from the
tensors' shapes (``config_from_state_dict``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Mapping

import torch

from sdumc_tpu_torch.convert import safetensors_io
from sdumc_tpu_torch.models.eva02 import Eva02Config, Eva02Model

TRUNK = ("cls_token", "pos_embed", "patch_embed.", "blocks.", "fc_norm.")


def config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Eva02Config:
    """The architecture from the tensors' shapes. The head count is not in
    them: the published family keeps head_dim 64."""
    D, _, p, _ = sd["patch_embed.proj.weight"].shape
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    grid = int(round((sd["pos_embed"].shape[1] - 1) ** 0.5))
    return Eva02Config(hidden_size=D, num_layers=n_layers, num_heads=max(D // 64, 1),
                       mlp_hidden=sd["blocks.0.mlp.fc1_g.weight"].shape[0],
                       image_size=grid * p, patch_size=p, ref_grid=(grid, grid))


def read_raw_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the directory: its ``*.safetensors`` files in name
    order, else the ``pytorch_model.bin`` weights (JAX's
    ``hf_glm._load_raw_state_dict``)."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        return safetensors_io.load_hf_weights(model_dir)
    sd: Dict[str, torch.Tensor] = {}
    for path in files:
        sd.update(safetensors_io.load_file(path))
    return sd


def trunk_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``model.`` stripped, a final ``norm`` taken as ``fc_norm``, the trunk's
    tensors kept, f32."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in state_dict.items()}
    if "fc_norm.weight" not in sd and "norm.weight" in sd:
        sd["fc_norm.weight"], sd["fc_norm.bias"] = sd.pop("norm.weight"), sd.pop("norm.bias")
    return {k: v.float() for k, v in sd.items() if k.startswith(TRUNK)}


def load_timm_eva02(model_dir: str):
    """(Eva02Config, Eva02Model in eval mode on the CPU)."""
    sd = trunk_state_dict(read_raw_state_dict(model_dir))
    cfg = config_from_state_dict(sd)
    with torch.device("meta"):
        model = Eva02Model(cfg)
    return cfg, safetensors_io.assign_weights(model, sd, model_dir)
