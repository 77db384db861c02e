"""RegNetX and RegNetY encoders (counterpart of stcd_tpu/encoders/regnet.py)
under timm's names: ``stem.conv`` / ``stem.bn``, ``s{1..4}.b{j}.conv1..3``
(each ``.conv`` and ``.bn``), ``se.fc1`` / ``se.fc2`` and
``downsample.conv`` / ``.bn``.

Stage widths, depths and groups follow from the published (w0, wa, wm,
group_size, depth) by RegNet's quantised linear rule. A block is 1x1 ->
grouped 3x3 (the stride) -> [squeeze-excite, RegNetY, to round(in_c *
0.25)] -> 1x1 with a 1x1 downsample. Dilation (smp's make_dilated) covers
stages 2..4; stage 1 always keeps its stride.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from stcd_tpu_torch.encoders.dilation import make_dilated_rates
from stcd_tpu_torch.layers.modules import ConvNorm

# name: (w0, wa, wm, group_size, depth, se_ratio)
_REGNET_CFGS = {
    "regnetx_002": (24, 36.44, 2.49, 8, 13, 0.0),
    "regnetx_004": (24, 24.48, 2.54, 16, 22, 0.0),
    "regnetx_006": (48, 36.97, 2.24, 24, 16, 0.0),
    "regnetx_008": (56, 35.73, 2.28, 16, 16, 0.0),
    "regnetx_016": (80, 34.01, 2.25, 24, 18, 0.0),
    "regnetx_032": (88, 26.31, 2.25, 48, 25, 0.0),
    "regnetx_040": (96, 38.65, 2.43, 40, 23, 0.0),
    "regnetx_064": (184, 60.83, 2.07, 56, 17, 0.0),
    "regnetx_080": (80, 49.56, 2.88, 120, 23, 0.0),
    "regnetx_120": (168, 73.36, 2.37, 112, 19, 0.0),
    "regnetx_160": (216, 55.59, 2.1, 128, 22, 0.0),
    "regnetx_320": (320, 69.86, 2.0, 168, 23, 0.0),
    "regnety_002": (24, 36.44, 2.49, 8, 13, 0.25),
    "regnety_004": (48, 27.89, 2.09, 8, 16, 0.25),
    "regnety_006": (48, 32.54, 2.32, 16, 15, 0.25),
    "regnety_008": (56, 38.84, 2.4, 16, 14, 0.25),
    "regnety_016": (48, 20.71, 2.65, 24, 27, 0.25),
    "regnety_032": (80, 42.63, 2.66, 24, 21, 0.25),
    "regnety_040": (96, 31.41, 2.24, 64, 22, 0.25),
    "regnety_064": (112, 33.22, 2.27, 72, 25, 0.25),
    "regnety_080": (192, 76.82, 2.19, 56, 17, 0.25),
    "regnety_120": (168, 73.36, 2.37, 112, 19, 0.25),
    "regnety_160": (200, 106.23, 2.48, 112, 18, 0.25),
    "regnety_320": (232, 115.89, 2.53, 232, 20, 0.25),
}


def generate_regnet(name: str) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """(stage widths, stage depths, group widths) by the quantised linear rule."""
    w0, wa, wm, group_size, depth, _ = _REGNET_CFGS[name]
    widths_cont = np.arange(depth) * wa + w0
    width_exps = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, width_exps) / 8) * 8).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    groups = np.minimum(group_size, stage_widths)
    stage_widths = (np.round(stage_widths / groups) * groups).astype(int)
    return (tuple(int(w) for w in stage_widths), tuple(int(d) for d in stage_depths),
            tuple(int(g) for g in groups))


def regnet_out_channels(name: str) -> Tuple[int, ...]:
    return (3, 32) + generate_regnet(name)[0]


class _SE(nn.Module):
    def __init__(self, c: int, rd: int, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(c, rd, 1, device=device)
        self.fc2 = nn.Conv2d(rd, c, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class RegNetBlock(nn.Module):
    """stcd_tpu/encoders/regnet.py:80-124; the convs in its order (conv1,
    conv2, the squeeze-excite, conv3, the downsample)."""

    def __init__(self, in_c: int, width: int, group_width: int, stride: int = 1,
                 dilation: int = 1, se_ratio: float = 0.0, device=None):
        super().__init__()
        d = dilation
        s = 1 if d > 1 else stride
        self.conv1 = ConvNorm(in_c, width, 1, device=device)
        self.conv2 = ConvNorm(width, width, 3, stride=s, dilation=d,
                              groups=width // group_width, device=device)
        self.se = (_SE(width, max(1, int(round(in_c * se_ratio))), device)
                   if se_ratio > 0 else None)
        self.conv3 = ConvNorm(width, width, 1, device=device)
        self.downsample = (ConvNorm(in_c, width, 1, stride=s, device=device)
                           if stride != 1 or in_c != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        if self.se is not None:
            h = self.se(h)
        h = self.conv3(h)
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(h + identity)


class RegNetEncoder(nn.Module):
    """smp-contract RegNet (stcd_tpu/encoders/regnet.py:127-155): [x, stem 32
    (/2), s1 .. s4]."""

    supports_dilation = True
    head_prefixes = ("head.",)

    def __init__(self, arch: str = "regnetx_002", depth: int = 5,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 in_channels: int = 3, device=None):
        super().__init__()
        widths, depths, groups = generate_regnet(arch)
        se_ratio = _REGNET_CFGS[arch][5]
        flags = replace_stride_with_dilation
        rates = make_dilated_rates(flags)
        self.depth = depth
        self.out_channels = regnet_out_channels(arch)[:depth + 1]
        if depth >= 1:
            self.stem = ConvNorm(in_channels, 32, 3, stride=2, device=device)
        in_c = 32
        for i, width in enumerate(widths):
            if depth < 2 + i:
                break
            dil = rates[i - 1] if i > 0 and flags[i - 1] else 1
            stage = nn.Module()
            for b in range(depths[i]):
                stage.add_module(f"b{b + 1}", RegNetBlock(in_c, width, groups[i],
                                                          2 if b == 0 else 1, dil, se_ratio,
                                                          device))
                in_c = width
            setattr(self, f"s{i + 1}", stage)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        if self.depth >= 1:
            x = torch.relu(self.stem(x))
            features.append(x)
        for i in range(1, min(self.depth, 5)):
            for block in getattr(self, f"s{i}").children():
                x = block(x)
            features.append(x)
        return features
