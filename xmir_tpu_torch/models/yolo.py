"""YOLOv5 lesion detector in PyTorch (port of xmir_tpu/models/yolo.py).

The ultralytics v6.0 YOLOv5 graph as ``nn.Module``s in NCHW: CSP backbone
(Conv / C3 / SPPF), PAN neck and the 3-scale anchor Detect head. Parameters
carry ultralytics' own names (``model.{i}.cv1.conv.weight``, ...,
``model.24.m.{k}``, the ``model.24.anchors`` buffer), so an ultralytics
state dict loads strictly with no rename table
(models/convert.py::load_yolov5_checkpoint). The JAX graph reaches no Pallas
kernel; here too the convolutions go to cuDNN, in f32 with TF32 off
(chestmir/lesions.py::detector_fn_from_checkpoint turns it off around each
call), as the JAX package's jitted apply runs.

Semantics of the ultralytics v6.0 modules, as in the JAX module:
  Conv   = Conv2d(bias=False, autopad k // 2; layer 0: k 6, s 2, p 2)
           + BatchNorm(eps=1e-3) + SiLU
  C3     = cv3(cat(bottlenecks(cv1(x)), cv2(x))), bottleneck e = 1.0
  SPPF   = cv2(cat(x, mp(x), mp2(x), mp3(x))), max pool k 5, s 1, p 2
           (padded with -inf, as flax's max_pool pads)
  Detect = sigmoid, xy = (2y + grid - 0.5) * stride, wh = (2y)^2 * anchor,
           rows anchor-major (b, na, ny, nx, no) over the three scales
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# default COCO-lineage anchors in PIXELS per stride-8/16/32 scale
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
DETECT = 24  # the Detect head's layer index


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


class ConvBnSiLU(nn.Module):
    """ultralytics ``Conv``: its BatchNorm is ``nn.BatchNorm2d`` (with
    ``num_batches_tracked``), so its state dict is ultralytics' own."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1, p: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2 if p is None else p, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(c, c, 1, 1)
        self.cv2 = ConvBnSiLU(c, c, 3, 1)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        hidden = int(cout * 0.5)
        self.cv1 = ConvBnSiLU(cin, hidden, 1, 1)
        self.cv2 = ConvBnSiLU(cin, hidden, 1, 1)
        self.cv3 = ConvBnSiLU(2 * hidden, cout, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(hidden, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBnSiLU(cin, hidden, 1, 1)
        self.cv2 = ConvBnSiLU(hidden * 4, cout, 1, 1)
        self.k = k

    def pool(self, x):
        # max_pool2d pads with -inf, as flax's nn.max_pool does
        return F.max_pool2d(x, self.k, stride=1, padding=self.k // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.pool(x)
        y2 = self.pool(y1)
        return self.cv2(torch.cat([x, y1, y2, self.pool(y2)], dim=1))


class Detect(nn.Module):
    """One biased 1x1 conv a scale and the ``anchors`` buffer (nl, na, 2) in
    units of each scale's stride, as ultralytics stores it."""

    def __init__(self, num_classes: int, channels: Sequence[int], anchors=DEFAULT_ANCHORS):
        super().__init__()
        self.na, self.no = len(anchors[0]), 5 + num_classes
        self.m = nn.ModuleList(nn.Conv2d(c, self.na * self.no, 1) for c in channels)
        strides = torch.tensor(STRIDES, dtype=torch.float32).view(-1, 1, 1)
        self.register_buffer("anchors", torch.tensor(anchors, dtype=torch.float32) / strides)

    def forward(self, feats):
        return [conv(f) for conv, f in zip(self.m, feats)]


class YOLOv5(nn.Module):
    """The v6.0 graph: ``self.model`` holds ultralytics' 25 layers by index
    (11 and 15 upsample nearest 2x; 12, 16, 19 and 22 are ultralytics'
    parameterless Concat layers, here placeholders: the forward
    concatenates).

    forward(x (B, 3, S, S) float32 in [0, 1]) -> {"maps": three raw head
    maps (B, na * no, S / stride, S / stride), "prediction": (B, N, 5 + nc)
    decoded rows (when ``decode``)}: the tensor the reference's ONNX
    sessions emit (reference inference.py:318-327)."""

    def __init__(self, num_classes: int = 14, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50, anchors=DEFAULT_ANCHORS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes

        def w(c):
            return make_divisible(c * width_multiple, 8)

        def d(n):
            return max(round(n * depth_multiple), 1)

        c64, c128, c256, c512, c1024 = w(64), w(128), w(256), w(512), w(1024)
        self.model = nn.ModuleList([
            ConvBnSiLU(3, c64, 6, 2, 2),                 # 0
            ConvBnSiLU(c64, c128, 3, 2),                 # 1
            C3(c128, c128, d(3)),                        # 2
            ConvBnSiLU(c128, c256, 3, 2),                # 3
            C3(c256, c256, d(6)),                        # 4: P3
            ConvBnSiLU(c256, c512, 3, 2),                # 5
            C3(c512, c512, d(9)),                        # 6: P4
            ConvBnSiLU(c512, c1024, 3, 2),               # 7
            C3(c1024, c1024, d(3)),                      # 8
            SPPF(c1024, c1024),                          # 9
            ConvBnSiLU(c1024, c512, 1, 1),               # 10
            nn.Upsample(scale_factor=2, mode="nearest"),  # 11
            nn.Identity(),                               # 12
            C3(c512 + c512, c512, d(3), False),          # 13
            ConvBnSiLU(c512, c256, 1, 1),                # 14
            nn.Upsample(scale_factor=2, mode="nearest"),  # 15
            nn.Identity(),                               # 16
            C3(c256 + c256, c256, d(3), False),          # 17: out P3
            ConvBnSiLU(c256, c256, 3, 2),                # 18
            nn.Identity(),                               # 19
            C3(c256 + c256, c512, d(3), False),          # 20: out P4
            ConvBnSiLU(c512, c512, 3, 2),                # 21
            nn.Identity(),                               # 22
            C3(c512 + c512, c1024, d(3), False),         # 23: out P5
            Detect(num_classes, (c256, c512, c1024), anchors),  # 24
        ])
        if generator is not None:
            init_weights_(self, generator)

    @property
    def anchors_px(self) -> torch.Tensor:
        """(nl, na, 2) anchors in pixels (each scale's row times its stride, a
        power of two: exact; no host tensor is copied to the device, so a
        forward never waits for the device)."""
        anchors = self.detect.anchors.float()
        return torch.stack([anchors[i] * s for i, s in enumerate(STRIDES)])

    @property
    def detect(self) -> Detect:
        return self.model[DETECT]

    def forward(self, x):
        """{"maps": the three raw head maps, "prediction": their (B, N, 5 + nc)
        decode}; ``self.detect`` alone gives the maps."""
        m = self.model
        x = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x))
        p4 = m[6](m[5](p3))
        x = m[9](m[8](m[7](p4)))
        t10 = m[10](x)
        x = m[13](torch.cat([m[11](t10), p4], dim=1))
        t14 = m[14](x)
        o17 = m[17](torch.cat([m[15](t14), p3], dim=1))
        o20 = m[20](torch.cat([m[18](o17), t14], dim=1))
        o23 = m[23](torch.cat([m[21](o20), t10], dim=1))
        maps = self.detect((o17, o20, o23))
        return {"maps": maps, "prediction": self.decode_maps(maps)}

    def decode_maps(self, maps: Sequence[torch.Tensor]) -> torch.Tensor:
        """ultralytics v6 inference decode (Detect.forward), in f32 whatever
        the maps' dtype: y = sigmoid(p); xy = (2y + grid - 0.5) * stride;
        wh = (2y)^2 * anchor_px; rows anchor-major, concatenated over the
        scales to (B, N, 5 + nc)."""
        na, no = self.detect.na, self.detect.no
        anchors = self.anchors_px
        outs = []
        for i, p in enumerate(maps):
            b, _, ny, nx = p.shape
            stride = STRIDES[i]
            # (b, na * no, ny, nx) -> (b, na, ny, nx, no): ultralytics flattens
            # anchor-major
            y = torch.sigmoid(p.float().reshape(b, na, no, ny, nx).permute(0, 1, 3, 4, 2))
            gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                    torch.arange(nx, device=p.device), indexing="ij")
            grid = torch.stack([gx, gy], dim=-1).float() - 0.5  # (ny, nx, 2)
            xy = (y[..., 0:2] * 2.0 + grid) * stride
            wh = (y[..., 2:4] * 2.0) ** 2 * anchors[i].view(1, na, 1, 1, 2)
            outs.append(torch.cat([xy, wh, y[..., 4:]], dim=-1).reshape(b, -1, no))
        return torch.cat(outs, dim=1)


def init_weights_(model: YOLOv5, generator: torch.Generator):
    """PyTorch's default Conv2d init (kaiming-uniform with a = sqrt(5): weights
    and biases in +-1 / sqrt(fan_in)), BatchNorm weight 1 / bias 0, then
    ultralytics' ``_initialize_biases`` on the Detect convs (objectness
    log(8 / (640 / s)^2), classes log(0.6 / (nc - 0.99))), drawn from
    ``generator``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1) * bound)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        det = model.detect
        for conv, s in zip(det.m, STRIDES):
            b = conv.bias.view(det.na, det.no)
            b[:, 4] += math.log(8 / (640 / s) ** 2)
            b[:, 5:] += math.log(0.6 / (det.no - 5 - 0.99))

