"""LinkNet decoder (counterpart of stcd_tpu/decoders/linknet.py:15-56) under
smp's names: ``blocks.{i}.block.{0,1,2}``, where ``0`` and ``2`` are 1x1
ConvBNReLU and ``1`` is TransposeX2: ``1.0`` a ``ConvTranspose2d(k=4,
stride 2, padding 1)`` (an exact 2x), ``1.1`` its BatchNorm."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import ConvBNReLU
from stcd_tpu_torch.layers.norm import BatchNorm


class TransposeX2(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, use_batchnorm: bool = True,
                 device=None):
        layers = [nn.ConvTranspose2d(in_channels, out_channels, 4, stride=2, padding=1,
                                     device=device)]
        if use_batchnorm:
            layers.append(BatchNorm(out_channels, device=device))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(super().forward(x))


class LinknetDecoderBlock(nn.Module):
    """1x1 down to a quarter of the input width, the 2x transposed conv, 1x1
    up to ``out_channels``, then the skip added."""

    def __init__(self, in_channels: int, out_channels: int, use_batchnorm: bool = True,
                 device=None):
        super().__init__()
        c4 = in_channels // 4
        self.block = nn.Sequential(
            ConvBNReLU(in_channels, c4, 1, use_batchnorm=use_batchnorm, device=device),
            TransposeX2(c4, c4, use_batchnorm=use_batchnorm, device=device),
            ConvBNReLU(c4, out_channels, 1, use_batchnorm=use_batchnorm, device=device))

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.block(x)
        return x if skip is None else x + skip


class LinknetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], prefinal_channels: int = 32,
                 n_blocks: int = 5, use_batchnorm: bool = True, device=None):
        super().__init__()
        channels = list(encoder_channels[1:])[::-1] + [prefinal_channels]
        self.blocks = nn.ModuleList(
            LinknetDecoderBlock(channels[i], channels[i + 1], use_batchnorm, device=device)
            for i in range(n_blocks))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        feats = features[1:][::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
