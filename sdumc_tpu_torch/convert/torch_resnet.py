"""A torchvision ResNet ``.pth`` -> the port's ResNetEmbedding (the port of
``sdumc_tpu/convert/torch_resnet.py``).

The blob is ``{"state_dict": ...}`` or a bare state dict (torchvision's
released files); ``module.`` prefixes are stripped and the ``fc`` head
dropped, as the reference truncates the model before it
(extract_imagenet_embedding.py:153-155). The file is read with
``weights_only=True`` (JAX reads it with ``False``,
``sdumc_tpu/extract/vision_hf.py:148``). The blocks and widths are read
from the keys, so ResNet-18 and narrower variants of its layout load.
"""

from __future__ import annotations

from typing import Dict

import torch

from sdumc_tpu_torch.convert.torch_manet import manet_state_dict
from sdumc_tpu_torch.models.resnet import ResNetConfig, ResNetEmbedding


def config_from_state_dict(sd: Dict[str, torch.Tensor]) -> ResNetConfig:
    blocks, channels = [], []
    li = 1
    while f"layer{li}.0.conv1.weight" in sd:
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        blocks.append(n)
        channels.append(sd[f"layer{li}.0.conv1.weight"].shape[0])
        li += 1
    return ResNetConfig(blocks=tuple(blocks), channels=tuple(channels),
                        stem_channels=sd["conv1.weight"].shape[0])


def load_resnet(path: str, device="cpu"):
    """(ResNetEmbedding in eval mode on ``device``, {"missing", "unexpected"}
    keys) from a ``.pth``, loaded with strict=False and its report printed,
    as ``load_manet`` prints its own."""
    sd = manet_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    model = ResNetEmbedding(config_from_state_dict(sd))
    result = model.load_state_dict(sd, strict=False)
    report = {"missing": list(result.missing_keys), "unexpected": list(result.unexpected_keys)}
    print(f"loaded ResNet {path}: missing keys {report['missing']}, "
          f"unexpected keys {report['unexpected']}")
    return model.to(device).eval(), report
