"""MANet face-expression encoder, the visual feature extractor.

The port of ``sdumc_tpu/models/manet.py`` (reference
feature_extraction/visual/manet/model/{manet,attention}.py): a two-branch
ResNet-18-style network over 224x224 face crops. Branch 1 cuts the 28x28
map after ``layer2`` into four 14x14 patches, each through its own stack of
CBAM attention blocks; branch 2 is a multi-scale (Res2Net-style split)
stack over the whole map. The two 512-d global averages concatenate into
the [B, 1024] per-frame embedding (``return_embedding=True``), or go
through ``fc_1`` / ``fc_2`` to the two heads' logits.

NCHW, with the reference's module names (``layer1.0.conv1``,
``layer3_1_p1.0.cbam.ChannelGate.mlp.1``, ``layer3_2.0.conv1_2_1``,
``downsample.0`` / ``.1``, ``fc_1``, ...), so the released RAF-DB ``.pth``
loads as a state dict (``convert/torch_manet.py``). BatchNorm2d everywhere
(eps 1e-5, momentum 0.1; the spatial gate's momentum 0.01, flax's 0.99).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MANetConfig:
    layers: Sequence[int] = (2, 2, 2, 2)
    num_classes: int = 7  # RAF-DB checkpoint


def conv3x3(inplanes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)


def conv1x1(inplanes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)


def _downsample(inplanes: int, planes: int, stride: int):
    if stride == 1 and inplanes == planes:
        return None
    return nn.Sequential(conv1x1(inplanes, planes, stride), nn.BatchNorm2d(planes))


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride)

    def residual(self, x):
        return self.bn2(self.conv2(self.relu(self.bn1(self.conv1(x)))))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(self.residual(x) + identity)


class ChannelGate(nn.Module):
    """A shared MLP over the global average and max pools; sigmoid scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(channels, channels // reduction),
                                 nn.ReLU(), nn.Linear(channels // reduction, channels))

    def forward(self, x):
        att = self.mlp(x.mean(dim=(2, 3))) + self.mlp(x.amax(dim=(2, 3)))
        return x * torch.sigmoid(att)[:, :, None, None]


class BasicConv(nn.Module):
    """The spatial gate's conv (7x7, 2 -> 1, no bias) + BN."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3, bias=False)
        self.bn = nn.BatchNorm2d(1, eps=1e-5, momentum=0.01)

    def forward(self, x):
        return self.bn(self.conv(x))


class SpatialGate(nn.Module):
    """[max, mean] over channels (in that order) -> conv7 -> BN -> sigmoid."""

    def __init__(self):
        super().__init__()
        self.spatial = BasicConv()

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(pooled))


class CBAM(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.ChannelGate = ChannelGate(channels, reduction)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class AttentionBlock(BasicBlock):
    """A basic block whose residual branch ends in CBAM."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__(inplanes, planes, stride)
        self.cbam = CBAM(planes, 16)

    def residual(self, x):
        return self.cbam(super().residual(x))


class MulScaleBlock(nn.Module):
    """Res2Net-style cascaded split block, two parallel cascades summed."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        width = planes // 4
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        for tag in (1, 2):
            for i in range(1, 5):
                setattr(self, f"conv{tag}_2_{i}", conv3x3(width, width))
                setattr(self, f"bn{tag}_2_{i}", nn.BatchNorm2d(width))
        self.downsample = _downsample(inplanes, planes, stride)

    def _cascade(self, tag: int, splits):
        outs, prev = [], None
        for i in range(4):
            inp = splits[i] if i == 0 else prev + splits[i]
            o = getattr(self, f"bn{tag}_2_{i + 1}")(getattr(self, f"conv{tag}_2_{i + 1}")(inp))
            outs.append(o)
            prev = torch.relu(o)
        return torch.cat(outs, dim=1)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        splits = out.chunk(4, dim=1)
        out = self._cascade(1, splits) + self._cascade(2, splits)
        return self.relu(out + identity)


def _stage(block, inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    return nn.Sequential(*(block(inplanes if i == 0 else planes, planes, stride if i == 0 else 1)
                           for i in range(blocks)))


class MANet(nn.Module):
    def __init__(self, cfg: MANetConfig = MANetConfig()):
        super().__init__()
        self.cfg = cfg
        n = cfg.layers
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = _stage(BasicBlock, 64, 64, n[0], 1)
        self.layer2 = _stage(BasicBlock, 64, 128, n[1], 2)
        for p in range(1, 5):
            setattr(self, f"layer3_1_p{p}", _stage(AttentionBlock, 128, 256, n[2], 2))
            setattr(self, f"layer4_1_p{p}", _stage(AttentionBlock, 256, 512, n[3], 1))
        self.layer3_2 = _stage(MulScaleBlock, 128, 256, n[2], 2)
        self.layer4_2 = _stage(MulScaleBlock, 256, 512, n[3], 2)
        self.fc_1 = nn.Linear(512, cfg.num_classes)
        self.fc_2 = nn.Linear(512, cfg.num_classes)

    def forward(self, x, return_embedding: bool = True):
        """x [B, 3, 224, 224] -> [B, 1024] (the two branches' 512-d
        averages), or (logits_1, logits_2)."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer2(self.layer1(x))
        patches = (x[:, :, 0:14, 0:14], x[:, :, 0:14, 14:28],
                   x[:, :, 14:28, 0:14], x[:, :, 14:28, 14:28])
        outs = [getattr(self, f"layer4_1_p{p}")(getattr(self, f"layer3_1_p{p}")(patch))
                for p, patch in enumerate(patches, start=1)]
        branch1 = torch.cat([torch.cat(outs[:2], dim=3), torch.cat(outs[2:], dim=3)], dim=2)
        emb1 = branch1.mean(dim=(2, 3))
        emb2 = self.layer4_2(self.layer3_2(x)).mean(dim=(2, 3))
        if return_embedding:
            return torch.cat([emb1, emb2], dim=1)
        return self.fc_1(emb1), self.fc_2(emb2)


def init_weights(model: MANet, seed: int) -> MANet:
    """Seeded weights as ResNet's init draws them: convs normal with He's
    fan-out std, BN scale 1 and bias 0, Linear layers torch's default, all
    from one generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)
    return model
