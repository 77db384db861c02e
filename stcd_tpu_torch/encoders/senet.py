"""SENet encoders (counterpart of stcd_tpu/encoders/senet.py) under
pretrainedmodels' names: ``layer0.conv1`` / ``bn1`` (senet154 also
``conv2``, ``bn2``, ``conv3``, ``bn3``), ``layer{1..4}.{b}.conv1..3``,
``bn1..3``, ``se_module.fc1`` / ``fc2`` and ``downsample.0`` / ``.1``.

- ``senet154``: conv1 1x1 to planes * 2, grouped (64) 3x3 conv2 with the
  stride to planes * 4; a three-conv 3x3 stem (64, 64, 128); a 3x3
  downsample after layer1.
- ``se_resnet*``: the stride on conv1 (1x1), a 7x7 stem.
- ``se_resnext*_32x4d``: width (planes * 4 // 64) * 32, the stride on conv2.

Every block ends with a squeeze-excite (reduction 16) on the residual
branch. Stage 1 is layer0 without its pool; the pool is a 3x3 / 2 max pool
with ``ceil_mode=True`` and no padding. The convs run in the JAX block's
order (conv1, conv2, conv3, the squeeze-excite, then the downsample), the
order of the int8 conv sites; pretrainedmodels runs the downsample before
the squeeze-excite, which gives the same values.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.norm import BatchNorm

# name: (block_kind, layers, groups, reduction, downsample_kernel, input_3x3)
_SENET_CFGS = {
    "senet154": ("se", (3, 8, 36, 3), 64, 16, 3, True),
    "se_resnet50": ("se_resnet", (3, 4, 6, 3), 1, 16, 1, False),
    "se_resnet101": ("se_resnet", (3, 4, 23, 3), 1, 16, 1, False),
    "se_resnet152": ("se_resnet", (3, 8, 36, 3), 1, 16, 1, False),
    "se_resnext50_32x4d": ("se_resnext", (3, 4, 6, 3), 32, 16, 1, False),
    "se_resnext101_32x4d": ("se_resnext", (3, 4, 23, 3), 32, 16, 1, False),
}


def senet_out_channels(name: str) -> Tuple[int, ...]:
    return (3, 128 if _SENET_CFGS[name][5] else 64, 256, 512, 1024, 2048)


class SEModule(nn.Module):
    """Global average -> ``fc1`` (1x1, /reduction) -> relu -> ``fc2`` ->
    sigmoid gate."""

    def __init__(self, channels: int, reduction: int, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, device=device)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class SENetBlock(nn.Module):
    """The three SE bottlenecks, by ``kind`` (stcd_tpu/encoders/senet.py:69-118)."""

    def __init__(self, kind: str, in_c: int, planes: int, groups: int, reduction: int,
                 stride: int = 1, dilation: int = 1, downsample: bool = False,
                 downsample_kernel: int = 1, base_width: int = 4, device=None):
        super().__init__()
        out_c = planes * 4
        if kind == "se":
            c1, c2, g, s1, s2 = planes * 2, planes * 4, groups, 1, stride
        elif kind == "se_resnet":
            c1, c2, g, s1, s2 = planes, planes, 1, stride, 1
        else:
            width = (planes * base_width // 64) * groups
            c1, c2, g, s1, s2 = width, width, groups, 1, stride
        d = dilation
        if d > 1:
            s1 = s2 = 1
        self.conv1 = nn.Conv2d(in_c, c1, 1, stride=s1, bias=False, device=device)
        self.bn1 = BatchNorm(c1, device=device)
        self.conv2 = nn.Conv2d(c1, c2, 3, stride=s2, padding=d, dilation=d, groups=g,
                               bias=False, device=device)
        self.bn2 = BatchNorm(c2, device=device)
        self.conv3 = nn.Conv2d(c2, out_c, 1, bias=False, device=device)
        self.bn3 = BatchNorm(out_c, device=device)
        self.se_module = SEModule(out_c, reduction, device)
        self.downsample = None
        if downsample:
            k = downsample_kernel
            self.downsample = nn.Sequential(
                nn.Conv2d(in_c, out_c, k, stride=1 if d > 1 else stride, padding=(k // 2) * d,
                          dilation=d, bias=False, device=device),
                BatchNorm(out_c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.se_module(self.bn3(self.conv3(h)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class _Layer0(nn.Module):
    def __init__(self, in_channels: int, input_3x3: bool, device=None):
        super().__init__()
        convs = ((64, 2), (64, 1), (128, 1)) if input_3x3 else ((64, 2),)
        c = in_channels
        for i, (out_c, s) in enumerate(convs, start=1):
            k = 3 if input_3x3 else 7
            setattr(self, f"conv{i}", nn.Conv2d(c, out_c, k, stride=s, padding=k // 2,
                                                bias=False, device=device))
            setattr(self, f"bn{i}", BatchNorm(out_c, device=device))
            c = out_c
        self.n = len(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class SENetEncoder(nn.Module):
    """smp-contract SENet (stcd_tpu/encoders/senet.py:121-183):
    [x, layer0 (/2), pool + layer1 (/4), layer2, layer3, layer4 (/32)]. A
    dilated layer (smp's make_dilated) runs every conv at stride 1 and the
    stage's rate."""

    supports_dilation = True
    head_prefixes = ("last_linear.",)

    def __init__(self, arch: str = "se_resnet50", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        kind, layers, groups, reduction, dk, input_3x3 = _SENET_CFGS[arch]
        self.depth = depth
        self.out_channels = senet_out_channels(arch)[:depth + 1]
        if depth >= 1:
            self.layer0 = _Layer0(in_channels, input_3x3, device)
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        in_c = 128 if input_3x3 else 64
        planes = (64, 128, 256, 512)
        for i in range(4):
            if depth < 2 + i:
                break
            stride = 1 if i == 0 else 2
            dilated = i > 0 and flags[i - 1]
            blocks = []
            for b in range(layers[i]):
                down = b == 0 and (stride != 1 or in_c != planes[i] * 4)
                blocks.append(SENetBlock(kind, in_c, planes[i], groups, reduction,
                                         stride if b == 0 else 1,
                                         rates[i - 1] if dilated else 1, down,
                                         1 if i == 0 else dk, device=device))
                in_c = planes[i] * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = self.layer0(x)
            features.append(x)
        for i in range(1, min(self.depth, 5)):
            if i == 1:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, f"layer{i}")(x)
            features.append(x)
        return features
