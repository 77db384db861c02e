"""FPN decoder (counterpart of stcd_tpu/decoders/fpn.py:14-59) under smp's
names: ``p5``, ``p{4,3,2}.skip_conv``, ``seg_blocks.{i}.block.{j}.block.{0,1}``
(a bias-free 3x3 conv and its GroupNorm).

The GroupNorm is flax's: 32 groups, epsilon 1e-6 (torch's default is 1e-5;
ROADMAP.md Queue 3 records the JAX package's choice). The 2x upsamples of
the segmentation blocks are bilinear with ``align_corners=True``; the
pyramid's are nearest. The final dropout is channel-wise (``Dropout2d``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import Dropout2d, resize_bilinear, upsample_nearest

GN_EPS = 1e-6  # flax.linen.GroupNorm's default


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, upsample: bool = False,
                 device=None):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False, device=device),
            nn.GroupNorm(32, out_channels, eps=GN_EPS, device=device), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block(x)
        if self.upsample:
            x = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
        return x


class FPNBlock(nn.Module):
    """Nearest 2x of the coarser level plus a 1x1 lateral conv of the skip."""

    def __init__(self, pyramid_channels: int, skip_channels: int, device=None):
        super().__init__()
        self.skip_conv = nn.Conv2d(skip_channels, pyramid_channels, 1, device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, 2) + self.skip_conv(skip)


class SegmentationBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_upsamples: int, device=None):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_channels, out_channels, bool(n_upsamples), device=device)]
        blocks += [Conv3x3GNReLU(out_channels, out_channels, True, device=device)
                   for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNDecoder(nn.Module):
    """``forward(features)`` over the last four levels (/4 .. /32): the
    lateral pyramid p5 .. p2, a segmentation block per level up to /4, merged
    by sum (``"add"``) or concatenation (``"cat"``), then the dropout."""

    def __init__(self, encoder_channels: Sequence[int], pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2,
                 merge_policy: str = "add", device=None):
        super().__init__()
        if merge_policy not in ("add", "cat"):
            raise ValueError(f"`merge_policy` must be one of: ['add', 'cat'], got {merge_policy}")
        c2, c3, c4, c5 = encoder_channels[-4:]
        self.merge_policy = merge_policy
        self.out_channels = segmentation_channels * (1 if merge_policy == "add" else 4)
        self.p5 = nn.Conv2d(c5, pyramid_channels, 1, device=device)
        self.p4 = FPNBlock(pyramid_channels, c4, device=device)
        self.p3 = FPNBlock(pyramid_channels, c3, device=device)
        self.p2 = FPNBlock(pyramid_channels, c2, device=device)
        self.seg_blocks = nn.ModuleList(
            SegmentationBlock(pyramid_channels, segmentation_channels, n, device=device)
            for n in (3, 2, 1, 0))
        self.dropout = Dropout2d(dropout)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        c2, c3, c4, c5 = features[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        outs = [block(p) for block, p in zip(self.seg_blocks, (p5, p4, p3, p2))]
        x = sum(outs) if self.merge_policy == "add" else torch.cat(outs, dim=1)
        return self.dropout(x)
