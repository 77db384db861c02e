"""PSPNet decoder (counterpart of stcd_tpu/decoders/pspnet.py:14-59) under
smp's names: ``psp.blocks.{i}.pool.1`` (a 1x1 ConvBNReLU; the 1x1 pool's has
no BatchNorm and keeps its bias) and ``conv`` (a 1x1 ConvBNReLU).

Each branch average-pools the deepest feature to 1, 2, 3 and 6 cells
(``F.adaptive_avg_pool2d``, whose windows are the JAX function's), convolves
it, and resizes it back bilinearly with ``align_corners=True``. The final
dropout is channel-wise (``Dropout2d``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import ConvBNReLU, Dropout2d, resize_bilinear


class PSPBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, pool_size: int,
                 use_batchnorm: bool = True, device=None):
        super().__init__()
        self.pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(pool_size),
            ConvBNReLU(in_channels, out_channels, 1,
                       use_batchnorm=use_batchnorm and pool_size != 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(self.pool(x), tuple(x.shape[2:]), align_corners=True)


class PSPModule(nn.Module):
    def __init__(self, in_channels: int, sizes: Sequence[int] = (1, 2, 3, 6),
                 use_batchnorm: bool = True, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            PSPBlock(in_channels, in_channels // len(sizes), size, use_batchnorm,
                     device=device)
            for size in sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([block(x) for block in self.blocks] + [x], dim=1)


class PSPDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], use_batchnorm: bool = True,
                 out_channels: int = 512, dropout: float = 0.2, device=None):
        super().__init__()
        c = encoder_channels[-1]
        self.psp = PSPModule(c, use_batchnorm=use_batchnorm, device=device)
        self.conv = ConvBNReLU(c + (c // 4) * 4, out_channels, 1, use_batchnorm=use_batchnorm,
                               device=device)
        self.dropout = Dropout2d(dropout)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        return self.dropout(self.conv(self.psp(features[-1])))
