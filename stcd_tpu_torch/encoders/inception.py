"""InceptionV4 and InceptionResNetV2 encoders (counterpart of
stcd_tpu/encoders/inception.py) under pretrainedmodels' names.

- ``InceptionV4Encoder``: ``features.{0..21}`` (three stem BasicConv2d,
  Mixed_3a/4a/5a, 4 x Inception_A, Reduction_A, 7 x Inception_B,
  Reduction_B, 3 x Inception_C, with ``branch*`` submodules); stages end
  after features 2, 4, 8, 14 and 21: (64 /2, 192 /4, 384 /8, 1024 /16,
  1536 /32).
- ``InceptionResNetV2Encoder``: ``conv2d_1a`` .. ``conv2d_4a``,
  ``mixed_5b``, ``repeat`` (10 x Block35), ``mixed_6a``, ``repeat_1`` (20 x
  Block17), ``mixed_7a``, ``repeat_2`` (9 x Block8), ``block8`` (no relu)
  and ``conv2d_7b``; the residual up-projections ``conv2d`` have biases.

BasicConv2d is conv (no bias) -> BatchNorm (eps 1e-3) -> relu. Every conv and
max pool pads k // 2 a side (smp patches pretrainedmodels' padding-0 3x3
convs and pools to padding 1), the stride-2 reductions too; the 3x3 average
pools leave the padding out of the count. Neither encoder dilates.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm


def inceptionv4_out_channels() -> Tuple[int, ...]:
    return (3, 64, 192, 384, 1024, 1536)


def inceptionresnetv2_out_channels() -> Tuple[int, ...]:
    return (3, 64, 192, 320, 1088, 1536)


class BasicConv2d(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel=3, stride: int = 1, device=None):
        super().__init__()
        ks = (kernel,) * 2 if isinstance(kernel, int) else kernel
        self.conv = nn.Conv2d(in_c, out_c, ks, stride=stride, padding=(ks[0] // 2, ks[1] // 2),
                              bias=False, device=device)
        self.bn = BatchNorm(out_c, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _seq(specs, device) -> nn.Sequential:
    """A branch of BasicConv2d: specs of (in, out, kernel[, stride])."""
    return nn.Sequential(*[BasicConv2d(*s, device=device) for s in specs])


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 1)


class _PoolConv(nn.Module):
    """A ``branch3`` of an average pool (index 0) and a BasicConv2d (``1``)."""

    def __init__(self, in_c: int, out_c: int, device=None):
        super().__init__()
        self.add_module("1", BasicConv2d(in_c, out_c, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, "1")(_avgpool3(x))


class Mixed_3a(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv = BasicConv2d(64, 96, 3, 2, device=device)

    def forward(self, x):
        return torch.cat([_maxpool3(x), self.conv(x)], 1)


class Mixed_4a(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = _seq([(160, 64, 1), (64, 96, 3)], device)
        self.branch1 = _seq([(160, 64, 1), (64, 64, (1, 7)), (64, 64, (7, 1)), (64, 96, 3)],
                            device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class Mixed_5a(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv = BasicConv2d(192, 192, 3, 2, device=device)

    def forward(self, x):
        return torch.cat([self.conv(x), _maxpool3(x)], 1)


class Inception_A(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(384, 96, 1, device=device)
        self.branch1 = _seq([(384, 64, 1), (64, 96, 3)], device)
        self.branch2 = _seq([(384, 64, 1), (64, 96, 3), (96, 96, 3)], device)
        self.branch3 = _PoolConv(384, 96, device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class Reduction_A(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(384, 384, 3, 2, device=device)
        self.branch1 = _seq([(384, 192, 1), (192, 224, 3), (224, 256, 3, 2)], device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool3(x)], 1)


class Inception_B(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(1024, 384, 1, device=device)
        self.branch1 = _seq([(1024, 192, 1), (192, 224, (1, 7)), (224, 256, (7, 1))], device)
        self.branch2 = _seq([(1024, 192, 1), (192, 192, (7, 1)), (192, 224, (1, 7)),
                             (224, 224, (7, 1)), (224, 256, (1, 7))], device)
        self.branch3 = _PoolConv(1024, 128, device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class Reduction_B(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = _seq([(1024, 192, 1), (192, 192, 3, 2)], device)
        self.branch1 = _seq([(1024, 256, 1), (256, 256, (1, 7)), (256, 320, (7, 1)),
                             (320, 320, 3, 2)], device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool3(x)], 1)


class Inception_C(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(1536, 256, 1, device=device)
        self.branch1_0 = BasicConv2d(1536, 384, 1, device=device)
        self.branch1_1a = BasicConv2d(384, 256, (1, 3), device=device)
        self.branch1_1b = BasicConv2d(384, 256, (3, 1), device=device)
        self.branch2_0 = BasicConv2d(1536, 384, 1, device=device)
        self.branch2_1 = BasicConv2d(384, 448, (3, 1), device=device)
        self.branch2_2 = BasicConv2d(448, 512, (1, 3), device=device)
        self.branch2_3a = BasicConv2d(512, 256, (1, 3), device=device)
        self.branch2_3b = BasicConv2d(512, 256, (3, 1), device=device)
        self.branch3 = _PoolConv(1536, 256, device)

    def forward(self, x):
        b0 = self.branch0(x)
        b1 = self.branch1_0(x)
        b1a, b1b = self.branch1_1a(b1), self.branch1_1b(b1)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        b2a, b2b = self.branch2_3a(b2), self.branch2_3b(b2)
        return torch.cat([b0, b1a, b1b, b2a, b2b, self.branch3(x)], 1)


# the features each smp stage 1..5 runs
_V4_STAGES = ((0, 3), (3, 5), (5, 9), (9, 15), (15, 22))


class InceptionV4Encoder(nn.Module):
    """smp-contract InceptionV4 (stcd_tpu/encoders/inception.py:78-169)."""

    head_prefixes = ("last_linear.",)

    def __init__(self, depth: int = 5, in_channels: int = 3, device=None):
        super().__init__()
        self.depth = depth
        self.out_channels = inceptionv4_out_channels()[:depth + 1]
        mods = [BasicConv2d(in_channels, 32, 3, 2, device=device),
                BasicConv2d(32, 32, 3, device=device), BasicConv2d(32, 64, 3, device=device),
                Mixed_3a(device), Mixed_4a(device), Mixed_5a(device)]
        mods += [Inception_A(device) for _ in range(4)] + [Reduction_A(device)]
        mods += [Inception_B(device) for _ in range(7)] + [Reduction_B(device)]
        mods += [Inception_C(device) for _ in range(3)]
        self.features = nn.Sequential(*mods[:_V4_STAGES[depth - 1][1] if depth else 0])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        for lo, hi in _V4_STAGES[:self.depth]:
            for i in range(lo, hi):
                x = self.features[i](x)
            features.append(x)
        return features


class Mixed_5b(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(192, 96, 1, device=device)
        self.branch1 = _seq([(192, 48, 1), (48, 64, 5)], device)
        self.branch2 = _seq([(192, 64, 1), (64, 96, 3), (96, 96, 3)], device)
        self.branch3 = _PoolConv(192, 64, device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17, device=None):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(320, 32, 1, device=device)
        self.branch1 = _seq([(320, 32, 1), (32, 32, 3)], device)
        self.branch2 = _seq([(320, 32, 1), (32, 48, 3), (48, 64, 3)], device)
        self.conv2d = nn.Conv2d(128, 320, 1, device=device)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1))
        return torch.relu(x + self.scale * up)


class Mixed_6a(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = BasicConv2d(320, 384, 3, 2, device=device)
        self.branch1 = _seq([(320, 256, 1), (256, 256, 3), (256, 384, 3, 2)], device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool3(x)], 1)


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10, device=None):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(1088, 192, 1, device=device)
        self.branch1 = _seq([(1088, 128, 1), (128, 160, (1, 7)), (160, 192, (7, 1))], device)
        self.conv2d = nn.Conv2d(384, 1088, 1, device=device)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return torch.relu(x + self.scale * up)


class Mixed_7a(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.branch0 = _seq([(1088, 256, 1), (256, 384, 3, 2)], device)
        self.branch1 = _seq([(1088, 256, 1), (256, 288, 3, 2)], device)
        self.branch2 = _seq([(1088, 256, 1), (256, 288, 3), (288, 320, 3, 2)], device)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), _maxpool3(x)], 1)


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, relu: bool = True, device=None):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.branch0 = BasicConv2d(2080, 192, 1, device=device)
        self.branch1 = _seq([(2080, 192, 1), (192, 224, (1, 3)), (224, 256, (3, 1))], device)
        self.conv2d = nn.Conv2d(448, 2080, 1, device=device)

    def forward(self, x):
        out = x + self.scale * self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return torch.relu(out) if self.relu else out


class InceptionResNetV2Encoder(nn.Module):
    """smp-contract InceptionResNetV2 (stcd_tpu/encoders/inception.py:172-263):
    [x, conv1a-2b (/2), pool + conv3b + conv4a (/4), pool + Mixed_5b + 10 x
    Block35 (/8), Mixed_6a + 20 x Block17 (/16), Mixed_7a + 9 x Block8 +
    Block8 + conv7b (/32)]."""

    head_prefixes = ("last_linear.",)

    def __init__(self, depth: int = 5, in_channels: int = 3, device=None):
        super().__init__()
        self.depth = depth
        self.out_channels = inceptionresnetv2_out_channels()[:depth + 1]
        if depth >= 1:
            self.conv2d_1a = BasicConv2d(in_channels, 32, 3, 2, device=device)
            self.conv2d_2a = BasicConv2d(32, 32, 3, device=device)
            self.conv2d_2b = BasicConv2d(32, 64, 3, device=device)
        if depth >= 2:
            self.conv2d_3b = BasicConv2d(64, 80, 1, device=device)
            self.conv2d_4a = BasicConv2d(80, 192, 3, device=device)
        if depth >= 3:
            self.mixed_5b = Mixed_5b(device)
            self.repeat = nn.Sequential(*[Block35(device=device) for _ in range(10)])
        if depth >= 4:
            self.mixed_6a = Mixed_6a(device)
            self.repeat_1 = nn.Sequential(*[Block17(device=device) for _ in range(20)])
        if depth >= 5:
            self.mixed_7a = Mixed_7a(device)
            self.repeat_2 = nn.Sequential(*[Block8(device=device) for _ in range(9)])
            self.block8 = Block8(1.0, relu=False, device=device)
            self.conv2d_7b = BasicConv2d(2080, 1536, 1, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stages = [
            lambda h: self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(h))),
            lambda h: self.conv2d_4a(self.conv2d_3b(_maxpool3(h))),
            lambda h: self.repeat(self.mixed_5b(_maxpool3(h))),
            lambda h: self.repeat_1(self.mixed_6a(h)),
            lambda h: self.conv2d_7b(self.block8(self.repeat_2(self.mixed_7a(h)))),
        ]
        features = [x]
        for stage in stages[:self.depth]:
            x = stage(x)
            features.append(x)
        return features
