"""Squeeze-and-excitation layers on NCHW tensors (counterpart of
stcd_tpu/layers/se.py:18-57, smp's decoders/unet/se.py). State_dict names
are smp's: ``fc1``, ``fc2`` (Linear) and ``conv`` (1x1 Conv2d)."""

from __future__ import annotations

import torch
from torch import nn


class ChannelSELayer(nn.Module):
    """Global average pool -> fc1 -> ReLU -> fc2 -> sigmoid gate per channel."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2, device=None):
        super().__init__()
        self.fc1 = nn.Linear(num_channels, num_channels // reduction_ratio, device=device)
        self.fc2 = nn.Linear(num_channels // reduction_ratio, num_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean((2, 3))))))
        return x * gate[:, :, None, None]


class SpatialSELayer(nn.Module):
    """1x1 conv to one channel -> sigmoid gate per pixel."""

    def __init__(self, num_channels: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(num_channels, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))


class ChannelSpatialSELayer(nn.Module):
    """cSE(x) + sSE(x)."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2, device=None):
        super().__init__()
        self.cSE = ChannelSELayer(num_channels, reduction_ratio, device=device)
        self.sSE = SpatialSELayer(num_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cSE(x) + self.sSE(x)
