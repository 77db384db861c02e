"""ResNet encoder with the smp stage contract (counterpart of
stcd_tpu/encoders/resnet.py). NCHW; state_dict names are torchvision's
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0/.1``), so
ImageNet checkpoints of torchvision load as they are.

``forward(x)`` returns the 6-level pyramid
[x, conv1-bn-relu (/2), maxpool+layer1 (/4), layer2 (/8), layer3 (/16),
layer4 (/32)]. BatchNorm is the port's own (``layers/norm.py``): momentum
0.9 in flax's sense, eps 1e-5, biased running variance, as the JAX encoder.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm


def _downsample(in_c: int, out_c: int, stride: int, device) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_c, out_c, 1, stride=stride, bias=False, device=device),
        BatchNorm(out_c, device=device))


class BasicBlock(nn.Module):
    """Two 3x3 convs (stcd_tpu/encoders/resnet.py:36-79). It does not
    dilate: like the reference's local copy it clamps the dilation to 1, so
    ``replace_stride_with_dilation`` on resnet18/34 only turns strides into 1."""

    expansion = 1

    def __init__(self, in_c: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, features, 3, stride=stride, padding=1, bias=False,
                               device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.downsample = _downsample(in_c, features, stride, device) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        # the shortcut's conv after the main branch's, in the JAX block's order,
        # which is the order of serving/quant.py's conv sites
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 with the stride on the 3x3 conv (torchvision v1.5;
    stcd_tpu/encoders/resnet.py:82-132). ResNeXt groups the 3x3 conv over
    ``width = int(features * base_width / 64) * groups`` channels."""

    expansion = 4

    def __init__(self, in_c: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 device=None):
        super().__init__()
        out_c = features * self.expansion
        width = int(features * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(in_c, width, 1, bias=False, device=device)
        self.bn1 = BatchNorm(width, device=device)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, groups=groups, bias=False, device=device)
        self.bn2 = BatchNorm(width, device=device)
        self.conv3 = nn.Conv2d(width, out_c, 1, bias=False, device=device)
        self.bn3 = BatchNorm(out_c, device=device)
        self.downsample = _downsample(in_c, out_c, stride, device) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)  # as above
        return torch.relu(out + identity)


# name: (block, blocks a stage, groups, width a group)
# (stcd_tpu/encoders/resnet.py:135-152)
RESNET_CFGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x4d": (Bottleneck, (3, 4, 23, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "resnext101_32x16d": (Bottleneck, (3, 4, 23, 3), 32, 16),
    "resnext101_32x32d": (Bottleneck, (3, 4, 23, 3), 32, 32),
    "resnext101_32x48d": (Bottleneck, (3, 4, 23, 3), 32, 48),
}


def resnet_out_channels(name: str) -> Tuple[int, ...]:
    e = RESNET_CFGS[name][0].expansion
    return (3, 64, 64 * e, 128 * e, 256 * e, 512 * e)


def _make_layer(block, in_c: int, features: int, blocks: int, stride: int, dilation: int,
                prev_dilation: int, device, **grouping) -> nn.Sequential:
    """One stage: the first block may downsample and takes the previous
    stage's dilation (stcd_tpu/encoders/resnet.py:166-211)."""
    out_c = features * block.expansion
    layers = [block(in_c, features, stride=stride, dilation=prev_dilation,
                    downsample=(stride != 1 or in_c != out_c), device=device, **grouping)]
    layers += [block(out_c, features, dilation=dilation, device=device, **grouping)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNetEncoder(nn.Module):
    """smp-contract ResNet and ResNeXt encoder
    (stcd_tpu/encoders/resnet.py:214-281); ``in_channels`` is the width of
    ``conv1``'s input.

    ``replace_stride_with_dilation``: a True entry turns the stride of
    layer2, layer3 or layer4 into dilation by torchvision's per-block rule,
    as the JAX encoder does: the stage's first block takes the previous
    dilation, the others the new one, and a BasicBlock never dilates.
    ``get_encoder(output_stride=16 | 8)`` sets (F, F, T) | (F, T, T)."""

    supports_dilation = True

    def __init__(self, arch: str = "resnet50", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        block, layers, groups, base_width = RESNET_CFGS[arch]
        grouping = dict(groups=groups, base_width=base_width) if block is Bottleneck else {}
        self.depth = depth
        self.out_channels = resnet_out_channels(arch)[:depth + 1]
        if depth >= 1:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False,
                                   device=device)
            self.bn1 = BatchNorm(64, device=device)
        if depth >= 2:
            self.layer1 = _make_layer(block, 64, 64, layers[0], 1, 1, 1, device, **grouping)
        in_c, dilation = 64 * block.expansion, 1
        for i, replace in enumerate(replace_stride_with_dilation):
            prev_dilation = dilation
            stride = 2
            if replace:
                dilation *= 2
                stride = 1
            if depth >= 3 + i:
                features = 128 * 2 ** i
                setattr(self, f"layer{2 + i}",
                        _make_layer(block, in_c, features, layers[1 + i], stride, dilation,
                                    prev_dilation, device, **grouping))
                in_c = features * block.expansion

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = torch.relu(self.bn1(self.conv1(x)))
            features.append(x)
        if self.depth >= 2:
            x = self.layer1(F.max_pool2d(x, 3, stride=2, padding=1))
            features.append(x)
        for i in range(2, self.depth):
            x = getattr(self, f"layer{i}")(x)
            features.append(x)
        return features
