"""DenseNet121 backbone in PyTorch (port of xmir_tpu/models/densenet.py).

The module tree and parameter names are torchvision's (conv0, norm0,
denseblockN.denselayerM.{norm1,conv1,norm2,conv2}, transitionN.{norm,conv},
norm5), so CheXNet / torchvision checkpoints load by name. The public forward
takes NHWC input and returns NHWC features like the JAX module; inside, the
tensors are NCHW views in channels_last memory, which is what cuDNN's fast
convolutions want.

BatchNorm (eps 1e-5) follows flax's ``nn.BatchNorm(momentum=0.9)``: in eval
mode the running statistics, in training mode the batch's mean and biased
variance, which also move the running buffers (``BatchNorm2d`` below).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


BN_MOMENTUM = 0.9  # flax's: running = 0.9 running + 0.1 batch


class BatchNorm2d(nn.Module):
    """BatchNorm over (B, H, W) of an NCHW tensor with torchvision's four
    tensors and no ``num_batches_tracked``: the state-dict keys of
    xmir_tpu/models/export.py.

    In training mode it is flax's ``nn.BatchNorm``: the batch mean and the
    BIASED batch variance, taken in f32 as max(E[x^2] - mean^2, 0) whatever
    x's dtype, normalise the batch, and the same biased variance moves
    ``running_var`` (``F.batch_norm(training=True)`` would feed the unbiased
    one, n / (n - 1) larger). The buffers stay f32 and are updated in place,
    under ``torch.no_grad()``, once per forward.

    Under a data-parallel world of more than one rank (``mesh``, set by
    parallel/data_parallel.py::sync_batch_norm) the statistics are those of
    the global batch, as the JAX package's mesh computes them: the per-rank
    sums of x and x^2 are summed across ranks (with their gradient), so
    every rank normalises alike and moves its running buffers alike."""

    mesh = None

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=BN_EPS)
        xs = x.float()
        if self.mesh is not None and self.mesh.n_data > 1:
            n = xs.shape[0] * xs.shape[2] * xs.shape[3] * self.mesh.n_data
            sums = self.mesh.all_reduce_with_grad(
                torch.stack([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3))]))
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        else:
            mean = xs.mean(dim=(0, 2, 3))
            var = torch.clamp((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1 - BN_MOMENTUM)
        scale = torch.rsqrt(var + BN_EPS) * self.weight.float()
        shift = self.bias.float() - mean * scale
        return (xs * scale[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1)
        self.norm2 = BatchNorm2d(bn_size * growth_rate)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class _DenseBlock(nn.Module):
    def __init__(self, num_layers: int, cin: int, growth_rate: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            _DenseLayer(cin + i * growth_rate, growth_rate))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class _Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNorm2d(cin)
        self.conv = _conv(cin, cout, 1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, stride=2)


class DenseNetBackbone(nn.Module):
    """torchvision-layout DenseNet feature extractor.

    forward(x (B, H, W, 3)) -> {"features": (B, H/32, W/32, C) post-norm5
    pre-ReLU map, "pooled": (B, C) after the reference's appended ReLU + GAP}.
    """

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64):
        super().__init__()
        self.conv0 = _conv(3, num_init_features, 7, stride=2, padding=3)
        self.norm0 = BatchNorm2d(num_init_features)
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.add_module(f"denseblock{i + 1}",
                            _DenseBlock(num_layers, num_features, growth_rate))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i + 1}",
                                _Transition(num_features, num_features // 2))
                num_features //= 2
        self.norm5 = BatchNorm2d(num_features)
        self.num_features = num_features

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> an NCHW view in channels_last memory
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name, module in self.named_children():
            if name.startswith(("denseblock", "transition")):
                x = module(x)
        x = self.norm5(x)
        features = x  # pre-ReLU map: what forward hooks capture in the reference
        pooled = torch.mean(F.relu(x), dim=(2, 3))
        return {"features": features.permute(0, 2, 3, 1), "pooled": pooled}


def init_weights_(module: nn.Module, generator: torch.Generator):
    """torchvision's DenseNet init, drawn from ``generator``: Kaiming-normal
    convolutions (fan_in, ReLU gain), BatchNorm weight 1 / bias 0, Linear
    weights N(0, 1/fan_in) and bias 0. Deterministic for a seeded CPU
    generator, whatever device the module later moves to."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = (2.0 / fan_in) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            elif isinstance(m, nn.Linear):
                std = (1.0 / m.in_features) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


def densenet121(generator: Optional[torch.Generator] = None) -> DenseNetBackbone:
    model = DenseNetBackbone(block_config=(6, 12, 24, 16))
    if generator is not None:
        init_weights_(model, generator)
    return model
