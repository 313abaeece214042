"""ATHNet deep-hashing model in PyTorch (port of xmir_tpu/models/ath.py;
reference ath_model.py:6-108): three small ResBlocks with spatial
attention, a hash layer and a class-type layer.

NHWC in, like the JAX module; inside, NCHW views in channels_last memory.
Pooling follows flax: ``max_pool`` pads with -inf (``F.max_pool2d``'s
padding), ``avg_pool`` counts the zero padding in its mean (zeros padded
in, then an unpadded ``F.avg_pool2d``). BatchNorm is the port's
flax-equivalent ``BatchNorm2d`` (eps 1e-5, momentum 0.9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .densenet import BatchNorm2d, _conv


def avg_pool_3x3(h):
    """flax's 3x3 stride-1 ``avg_pool`` with SAME padding: the zeros count in
    the mean. They are padded in by hand: PyTorch's CUDA backward of a padded
    ``F.avg_pool2d`` on a channels_last map is wrong (torch 2.11, CUDA 12.8;
    ROADMAP.md section 3), the unpadded pool's is right."""
    return F.avg_pool2d(F.pad(h, (1, 1, 1, 1)), 3, stride=1)


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _conv(2, 1, 3, padding=1)

    def forward(self, x):
        avg_out = torch.mean(x, dim=1, keepdim=True)
        max_out = torch.amax(x, dim=1, keepdim=True)
        return torch.sigmoid(self.conv(torch.cat([avg_out, max_out], dim=1)))


class ResBlock(nn.Module):
    """Two 3x3 convolutions; where the shape changes, the identity goes
    through a 3x3 convolution of the same stride (``down_conv``, padding 1:
    not a 1x1) and its BatchNorm."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = _conv(cout, cout, 3, padding=1)
        self.bn2 = BatchNorm2d(cout)
        self.down = cin != cout or stride != 1
        if self.down:
            self.down_conv = _conv(cin, cout, 3, stride=stride, padding=1)
            self.down_bn = BatchNorm2d(cout)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = self.down_bn(self.down_conv(x)) if self.down else x
        return F.relu(h + identity)


class ATHNet(nn.Module):
    """forward(x (B, S, S, 3)) -> (hash_codes (B, hash_size), logits (B,
    num_classes)); S = ``input_size``, a multiple of 8."""

    def __init__(self, hash_size: int, num_classes: int, input_size: int = 256):
        super().__init__()
        if input_size % 8 != 0:
            raise ValueError("input_size must be divisible by 8 for ATHNet.")
        self.block1 = ResBlock(3, 16, stride=2)
        self.sa = SpatialAttention()
        self.block2 = ResBlock(16, 8, stride=2)
        self.dense = ResBlock(8, 1, stride=2)
        flat = (input_size // 8) ** 2
        self.hashlayer = nn.Linear(flat, hash_size)
        self.typelayer = nn.Linear(flat, num_classes)

    def forward(self, x):
        h = self.block1(x.permute(0, 3, 1, 2))
        h = F.max_pool2d(h, 3, stride=1, padding=1)
        h = self.sa(h) * h
        h = self.block2(h)
        h = avg_pool_3x3(h)
        h = self.dense(h)
        # (B, 1, S/8, S/8): with one channel the NCHW flatten is the NHWC
        # flatten of the JAX module, so hashlayer's rows line up
        h = h.reshape(h.shape[0], -1)
        return self.hashlayer(h), self.typelayer(h)
