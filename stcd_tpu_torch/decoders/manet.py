"""MAnet decoder (counterpart of stcd_tpu/decoders/manet.py:14-131) under
smp's names: ``center`` is the position-attention block (``top_conv``,
``center_conv``, ``bottom_conv``, ``out_conv``); ``blocks.{i}`` is a
multi-scale fusion attention block (``hl_conv.{0,1}``, ``SE_hl``, ``SE_ll``,
``conv1``, ``conv2``) where there is a skip with channels, else a plain
decoder block (``conv1``, ``conv2``).

PAB's attention is plain ``torch.bmm`` and softmax, as smp's is: a softmax
over the whole flattened (hw)^2 map of a sample, and the (hw, C) product
reshaped row-major to (C, h, w) without a transpose (stock smp's order, which
the JAX decoder reproduces).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import ConvBNReLU, upsample_nearest


class PAB(nn.Module):
    def __init__(self, in_channels: int, pab_channels: int = 64, device=None):
        super().__init__()
        self.top_conv = nn.Conv2d(in_channels, pab_channels, 1, device=device)
        self.center_conv = nn.Conv2d(in_channels, pab_channels, 1, device=device)
        self.bottom_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1, device=device)
        self.out_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k = self.top_conv(x).flatten(2)  # (b, p, hw)
        q = self.center_conv(x).flatten(2).transpose(1, 2)  # (b, hw, p)
        v = self.bottom_conv(x).flatten(2).transpose(1, 2)  # (b, hw, c)
        sp = torch.softmax(torch.bmm(q, k).reshape(b, -1), dim=-1).reshape(b, h * w, h * w)
        out = torch.bmm(sp, v).reshape(b, c, h, w)
        return self.out_conv(x + out)


def _se(channels: int, reduced: int, device) -> nn.Sequential:
    return nn.Sequential(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(channels, reduced, 1, device=device), nn.ReLU(),
                         nn.Conv2d(reduced, channels, 1, device=device), nn.Sigmoid())


class MFAB(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 use_batchnorm: bool = True, reduction: int = 16, device=None):
        super().__init__()
        reduced = max(1, skip_channels // reduction)
        self.hl_conv = nn.Sequential(
            ConvBNReLU(in_channels, in_channels, 3, padding=1, use_batchnorm=use_batchnorm,
                       device=device),
            ConvBNReLU(in_channels, skip_channels, 1, use_batchnorm=use_batchnorm,
                       device=device))
        self.SE_hl = _se(skip_channels, reduced, device)
        self.SE_ll = _se(skip_channels, reduced, device)
        self.conv1 = ConvBNReLU(2 * skip_channels, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)
        self.conv2 = ConvBNReLU(out_channels, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(self.hl_conv(x), 2)
        x = torch.cat([x * (self.SE_hl(x) + self.SE_ll(skip)), skip], dim=1)
        return self.conv2(self.conv1(x))


class _PlainBlock(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 use_batchnorm: bool = True, device=None):
        super().__init__()
        self.conv1 = ConvBNReLU(in_channels + skip_channels, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)
        self.conv2 = ConvBNReLU(out_channels, out_channels, 3, padding=1,
                                use_batchnorm=use_batchnorm, device=device)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = upsample_nearest(x, 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class MAnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 n_blocks: int = 5, reduction: int = 16, use_batchnorm: bool = True,
                 pab_channels: int = 64, device=None):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        in_channels = [enc[0]] + list(decoder_channels[:-1])
        skip_channels = enc[1:] + [0]
        self.center = PAB(enc[0], pab_channels, device=device)
        self.blocks = nn.ModuleList(
            MFAB(i, s, o, use_batchnorm, reduction, device=device) if s > 0
            else _PlainBlock(i, s, o, use_batchnorm, device=device)
            for i, s, o in zip(in_channels, skip_channels[:n_blocks], decoder_channels))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        feats = features[1:][::-1]
        x, skips = self.center(feats[0]), feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
