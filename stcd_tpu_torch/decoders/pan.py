"""PAN decoder (counterpart of stcd_tpu/decoders/pan.py:16-92): a feature
pyramid attention block over the deepest level and three global attention
upsample blocks, under smp's names (``fpa.branch1.1``, ``fpa.mid.0``,
``fpa.down1.1``, ``fpa.down2.1``, ``fpa.down3.{1,2}``, ``fpa.conv{1,2}``,
``gau{1,2,3}.conv1.1``, ``gau{1,2,3}.conv2``, each a ``ConvBnRelu`` with
``conv`` and ``bn``). Every bilinear resize has ``align_corners=True``."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.layers.norm import BatchNorm


class ConvBnRelu(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 padding: int = 0, add_relu: bool = True, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding=padding,
                              device=device)
        self.bn = BatchNorm(out_channels, device=device)
        self.add_relu = add_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.add_relu else x


class FPABlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.branch1 = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                     ConvBnRelu(in_channels, out_channels, device=device))
        self.mid = nn.Sequential(ConvBnRelu(in_channels, out_channels, device=device))
        self.down1 = nn.Sequential(nn.MaxPool2d(2, 2),
                                   ConvBnRelu(in_channels, 1, 7, 3, device=device))
        self.down2 = nn.Sequential(nn.MaxPool2d(2, 2), ConvBnRelu(1, 1, 5, 2, device=device))
        self.down3 = nn.Sequential(nn.MaxPool2d(2, 2), ConvBnRelu(1, 1, 3, 1, device=device),
                                   ConvBnRelu(1, 1, 3, 1, device=device))
        self.conv2 = ConvBnRelu(1, 1, 5, 2, device=device)
        self.conv1 = ConvBnRelu(1, 1, 7, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        b1 = self.branch1(x).expand(-1, -1, h, w)
        mid = self.mid(x)
        x1 = self.down1(x)
        x2 = self.down2(x1)
        x3 = resize_bilinear(self.down3(x2), (h // 4, w // 4), align_corners=True)
        x2 = self.conv2(x2)
        z = resize_bilinear(x2 + x3, (h // 2, w // 2), align_corners=True)
        z = resize_bilinear(z + self.conv1(x1), (h, w), align_corners=True)
        return z * mid + b1


class GAUBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   ConvBnRelu(out_channels, out_channels, add_relu=False,
                                              device=device),
                                   nn.Sigmoid())
        self.conv2 = ConvBnRelu(in_channels, out_channels, 3, 1, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``x`` the finer encoder level, ``y`` the coarser decoded one."""
        y_up = resize_bilinear(y, tuple(x.shape[2:]), align_corners=True)
        return y_up + self.conv2(x) * self.conv1(y)


class PANDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], decoder_channels: int = 32,
                 device=None):
        super().__init__()
        self.fpa = FPABlock(encoder_channels[-1], decoder_channels, device=device)
        self.gau3 = GAUBlock(encoder_channels[-2], decoder_channels, device=device)
        self.gau2 = GAUBlock(encoder_channels[-3], decoder_channels, device=device)
        self.gau1 = GAUBlock(encoder_channels[-4], decoder_channels, device=device)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x5 = self.fpa(features[-1])
        x4 = self.gau3(features[-2], x5)
        x3 = self.gau2(features[-3], x4)
        return self.gau1(features[-4], x3)
