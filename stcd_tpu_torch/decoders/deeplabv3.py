"""DeepLabV3 and DeepLabV3+ decoders (counterpart of
stcd_tpu/decoders/deeplabv3.py:21-110) under smp's names.

- ASPP: ``convs.0`` (1x1), ``convs.1..3`` (3x3 at the atrous rates, or
  separable: ``convs.i.0.0`` depthwise, ``convs.i.0.1`` pointwise), each with
  its BatchNorm at ``.1``; ``convs.4`` the image pooling branch (``.1`` conv,
  ``.2`` BatchNorm); ``project`` (1x1, BatchNorm, ReLU, element-wise dropout
  0.5 drawn from the port's generator).
- DeepLabV3Decoder is a Sequential: ``0`` ASPP, ``1`` 3x3 conv, ``2``
  BatchNorm, ReLU.
- DeepLabV3PlusDecoder: ``aspp.0`` separable ASPP, ``aspp.1`` separable 3x3
  (``aspp.1.0`` depthwise, ``aspp.1.1`` pointwise), ``aspp.2`` BatchNorm;
  the bilinear upsample (``align_corners=True``) of the ASPP output by 4
  (2 at output stride 8), ``block1`` (1x1 to 48 over the /4 level, BatchNorm),
  ``block2`` (separable 3x3, BatchNorm).

The pooling branch's BatchNorm sees one value a sample and channel in train
mode. The port's BatchNorm (``layers/norm.py``) takes the moments over those
N values as the JAX one does; at N = 1 the variance is 0 and the branch gives
ReLU(bias) in both, where ``torch.nn.BatchNorm2d`` would raise.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import Dropout


class SeparableConv2d(nn.Sequential):
    """A bias-free depthwise 3x3 (``0``) and pointwise 1x1 (``1``)."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int = 1, device=None):
        super().__init__(
            nn.Conv2d(in_channels, in_channels, 3, padding=dilation, dilation=dilation,
                      groups=in_channels, bias=False, device=device),
            nn.Conv2d(in_channels, out_channels, 1, bias=False, device=device))


def _conv_bn_relu(conv: nn.Module, channels: int, device) -> nn.Sequential:
    return nn.Sequential(conv, BatchNorm(channels, device=device), nn.ReLU())


class ASPPPooling(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(in_channels, out_channels, 1, bias=False, device=device),
                         BatchNorm(out_channels, device=device), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), separable: bool = False,
                 device=None):
        super().__init__()
        convs = [_conv_bn_relu(nn.Conv2d(in_channels, out_channels, 1, bias=False,
                                         device=device), out_channels, device)]
        for rate in atrous_rates:
            conv = (SeparableConv2d(in_channels, out_channels, rate, device=device)
                    if separable else
                    nn.Conv2d(in_channels, out_channels, 3, padding=rate, dilation=rate,
                              bias=False, device=device))
            convs.append(_conv_bn_relu(conv, out_channels, device))
        convs.append(ASPPPooling(in_channels, out_channels, device=device))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            nn.Conv2d(len(convs) * out_channels, out_channels, 1, bias=False, device=device),
            BatchNorm(out_channels, device=device), nn.ReLU(), Dropout(0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class DeepLabV3Decoder(nn.Sequential):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), device=None):
        super().__init__(
            ASPP(encoder_channels[-1], out_channels, atrous_rates, device=device),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False, device=device),
            BatchNorm(out_channels, device=device), nn.ReLU())

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        return super().forward(features[-1])


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), output_stride: int = 16,
                 device=None):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"Output stride should be 8 or 16, got {output_stride}.")
        self.scale = 2 if output_stride == 8 else 4
        self.aspp = nn.Sequential(
            ASPP(encoder_channels[-1], out_channels, atrous_rates, separable=True,
                 device=device),
            SeparableConv2d(out_channels, out_channels, device=device),
            BatchNorm(out_channels, device=device), nn.ReLU())
        self.block1 = _conv_bn_relu(nn.Conv2d(encoder_channels[-4], 48, 1, bias=False,
                                              device=device), 48, device)
        self.block2 = _conv_bn_relu(SeparableConv2d(48 + out_channels, out_channels,
                                                    device=device), out_channels, device)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = self.aspp(features[-1])
        x = resize_bilinear(x, (x.shape[2] * self.scale, x.shape[3] * self.scale),
                            align_corners=True)
        return self.block2(torch.cat([x, self.block1(features[-4])], dim=1))
