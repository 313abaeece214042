"""ResNet-50 backbone in PyTorch (port of xmir_tpu/models/resnet.py).

torchvision's ResNet-50 v1.5 (the stride of a downsampling bottleneck on its
3x3 convolution), with torchvision's module names (conv1, bn1,
layerN.M.{conv1..3, bn1..3, downsample.0, downsample.1}), so torchvision and
reference checkpoints load by name. The public forward takes NHWC input and
returns NHWC features like the JAX module; inside, the tensors are NCHW views
in channels_last memory, which is what cuDNN's fast convolutions want.
BatchNorm is the port's flax-equivalent ``BatchNorm2d`` (models/densenet.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .densenet import BatchNorm2d, _conv, init_weights_

RESNET50_LAYERS = (3, 4, 6, 3)
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        self.downsample = nn.Sequential(
            _conv(cin, planes * EXPANSION, 1, stride=stride),
            BatchNorm2d(planes * EXPANSION)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNetBackbone(nn.Module):
    """torchvision ResNet-50 feature extractor (``layers`` bottlenecks a
    stage; fewer are for tests).

    forward(x (B, H, W, 3)) -> {"features": (B, H/32, W/32, 2048) final
    post-ReLU map, "pooled": (B, 2048) its global average}.
    """

    def __init__(self, layers: Sequence[int] = RESNET50_LAYERS):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm2d(64)
        cin, planes = 64, 64
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            mods = []
            for b in range(blocks):
                mods.append(Bottleneck(cin, planes, stride if b == 0 else 1, downsample=b == 0))
                cin = planes * EXPANSION
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))
            planes *= 2
        self.num_features = cin

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> an NCHW view in channels_last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name, module in self.named_children():
            if name.startswith("layer"):
                x = module(x)
        return {"features": x.permute(0, 2, 3, 1), "pooled": torch.mean(x, dim=(2, 3))}


def resnet50(generator: Optional[torch.Generator] = None) -> ResNetBackbone:
    model = ResNetBackbone(RESNET50_LAYERS)
    if generator is not None:
        init_weights_(model, generator)
    return model
