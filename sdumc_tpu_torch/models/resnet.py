"""torchvision's ResNet-18 cut before its fc head, the port of
``sdumc_tpu/models/resnet.py``: the reference's ImageNet visual extractor
takes the 512-d global average pool of each frame
(extract_imagenet_embedding.py:126-135,153-155).

The basic block is MANet's (``models/manet.py BasicBlock``, itself
torchvision's), so the submodules carry torchvision's names (``conv1``,
``bn1``, ``layer2.0.downsample.0``) and a torchvision state dict loads as
it is (``convert/torch_resnet.py``). NCHW, BatchNorm in eval mode.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from sdumc_tpu_torch.models.manet import BasicBlock


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    blocks: Tuple[int, ...] = (2, 2, 2, 2)      # resnet18
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    stem_channels: int = 64

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        base = dict(blocks=(1, 1, 1, 1), channels=(8, 16, 16, 24), stem_channels=8)
        base.update(kw)
        return ResNetConfig(**base)


class ResNetEmbedding(nn.Module):
    """[B, 3, H, W] ImageNet-normalised -> the pre-fc pool [B, channels[-1]]."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, cfg.stem_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(cfg.stem_channels)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = cfg.stem_channels
        for li, (n_blocks, ch) in enumerate(zip(cfg.blocks, cfg.channels), start=1):
            blocks = [BasicBlock(in_ch if bi == 0 else ch, ch, 2 if (bi == 0 and li > 1) else 1)
                      for bi in range(n_blocks)]
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(1, len(self.cfg.blocks) + 1):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))
