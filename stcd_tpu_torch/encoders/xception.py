"""Xception encoder (counterpart of stcd_tpu/encoders/xception.py) under
pretrainedmodels' names: ``conv1`` / ``bn1`` / ``conv2`` / ``bn2``,
``block{1..12}.rep.{i}`` (a Sequential of ReLU, SeparableConv2d with
``conv1`` depthwise and ``pointwise``, BatchNorm, and a trailing max pool),
``block{i}.skip`` / ``skipbn``, then ``conv3`` / ``bn3`` and ``conv4`` /
``bn4`` (separable).

Every conv pads symmetrically (smp patches the stem's padding-0 convs to
padding 1). Stages: stem (64 /2), block1 (128 /4), block2 (256 /8), blocks
3..11 (728 /16), block12 + conv3 + conv4 (2048 /32), the last without a
trailing relu. Xception does not dilate (smp's make_dilated refuses it).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm


def xception_out_channels(name: str = "xception") -> Tuple[int, ...]:
    return (3, 64, 128, 256, 728, 2048)


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (``conv1``) -> pointwise 1x1 (``pointwise``)."""

    def __init__(self, in_c: int, out_c: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, in_c, 3, padding=1, groups=in_c, bias=False, device=device)
        self.pointwise = nn.Conv2d(in_c, out_c, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.conv1(x))


class Block(nn.Module):
    """pretrainedmodels' Block (stcd_tpu/encoders/xception.py:53-86): reps x
    (relu, separable conv, BatchNorm), the first relu left out without
    ``start_with_relu``, a 3x3 max pool when strided, and a 1x1 conv skip
    when the shape changes. ``rep`` holds the modules at pretrainedmodels'
    indices."""

    def __init__(self, in_c: int, out_c: int, reps: int, stride: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True, device=None):
        super().__init__()
        rep: List[nn.Module] = []
        c = out_c if grow_first else in_c
        cin = in_c
        for i in range(reps):
            oc = out_c if (grow_first or i == reps - 1) else c
            if i > 0 or start_with_relu:
                rep.append(nn.ReLU())
            rep += [SeparableConv2d(cin, oc, device), BatchNorm(oc, device=device)]
            cin = oc
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)
        self.skip = self.skipbn = None
        if out_c != in_c or stride != 1:
            self.skip = nn.Conv2d(in_c, out_c, 1, stride=stride, bias=False, device=device)
            self.skipbn = BatchNorm(out_c, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rep(x)
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return h + skip


class XceptionEncoder(nn.Module):
    """smp-contract Xception (stcd_tpu/encoders/xception.py:89-129)."""

    head_prefixes = ("last_linear.", "fc.")

    def __init__(self, depth: int = 5, in_channels: int = 3, device=None):
        super().__init__()
        self.depth = depth
        self.out_channels = xception_out_channels()[:depth + 1]
        if depth >= 1:
            self.conv1 = nn.Conv2d(in_channels, 32, 3, stride=2, padding=1, bias=False,
                                   device=device)
            self.bn1 = BatchNorm(32, device=device)
            self.conv2 = nn.Conv2d(32, 64, 3, padding=1, bias=False, device=device)
            self.bn2 = BatchNorm(64, device=device)
        if depth >= 2:
            self.block1 = Block(64, 128, 2, 2, start_with_relu=False, device=device)
        if depth >= 3:
            self.block2 = Block(128, 256, 2, 2, device=device)
        if depth >= 4:
            self.block3 = Block(256, 728, 2, 2, device=device)
            for i in range(4, 12):
                setattr(self, f"block{i}", Block(728, 728, 3, device=device))
        if depth >= 5:
            self.block12 = Block(728, 1024, 2, 2, grow_first=False, device=device)
            self.conv3 = SeparableConv2d(1024, 1536, device)
            self.bn3 = BatchNorm(1536, device=device)
            self.conv4 = SeparableConv2d(1536, 2048, device)
            self.bn4 = BatchNorm(2048, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = torch.relu(self.bn1(self.conv1(x)))
            x = torch.relu(self.bn2(self.conv2(x)))
            features.append(x)
        stages = [(1,), (2,), tuple(range(3, 12)), (12,)]
        for i, blocks in enumerate(stages[:max(self.depth - 1, 0)]):
            for b in blocks:
                x = getattr(self, f"block{b}")(x)
            if i == 3:
                x = torch.relu(self.bn3(self.conv3(x)))
                x = self.bn4(self.conv4(x))
            features.append(x)
        return features
