"""DTCDSCN, the dual-task constrained deep Siamese network, on NCHW tensors
(counterpart of stcd_tpu/models/dtcdscn.py:32-197, ``define_G("DTCDSCN")``).
The live change-detection path of the reference: an SE-ResNet-34 Siamese
encoder run once on the 2N-batched pair, ``Dblock`` on the difference of the
deepest features, four ``DecoderBlock``s that add the signed stage
differences, and the ``ConvTranspose2d(k=4, s=2, p=1)`` head. The state_dict
names are the reference's (``firstconv``, ``encoder1.0.se.fc.0``,
``dblock_master.dilate1``, ``decoder4_master.scse.channel_excitation.0``,
``finaldeconv1_master`` ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import max_pool
from stcd_tpu_torch.layers.norm import BatchNorm


class SELayer(nn.Module):
    """Global average pool -> Linear -> ReLU -> Linear -> sigmoid gate; no
    biases (``fc.0``, ``fc.2``)."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction, bias=False,
                                          device=device),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels, bias=False,
                                          device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3))))[:, :, None, None]


class Dblock(nn.Module):
    """x plus the outputs of four cascaded 3x3 convs at dilations 1, 2, 4, 8,
    each followed by ReLU."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        for i, d in enumerate((1, 2, 4, 8)):
            setattr(self, f"dilate{i + 1}", nn.Conv2d(channels, channels, 3, padding=d,
                                                      dilation=d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, h = [], x
        for i in range(1, 5):
            h = torch.relu(getattr(self, f"dilate{i}")(h))
            outs.append(h)
        return x + sum(outs)


class SEBasicBlock(nn.Module):
    """ResNet basic block with SE before the residual add; the shortcut conv
    runs after the main branch, as in the JAX block."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 reduction: int = 16, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.se = SELayer(planes, reduction, device=device)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False,
                                                   device=device),
                                         BatchNorm(planes, device=device))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class SCSEBlock(nn.Module):
    """Channel excitation from the pooled map (1x1 convs, no bias) plus a
    spatial 1x1-conv gate; the two gated maps are summed."""

    def __init__(self, channels: int, reduction: int = 16, device=None):
        super().__init__()
        self.channel_excitation = nn.Sequential(
            nn.Conv2d(channels, channels // reduction, 1, bias=False, device=device),
            nn.ReLU(),
            nn.Conv2d(channels // reduction, channels, 1, bias=False, device=device),
            nn.Sigmoid())
        self.spatial_se = nn.Sequential(nn.Conv2d(channels, 1, 1, bias=False, device=device),
                                        nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chn_se = x * self.channel_excitation(x.mean((2, 3), keepdim=True))
        return chn_se + x * self.spatial_se(x)


class DecoderBlock(nn.Module):
    """1x1 reduce to in/4 + BN + ReLU, plus its scSE, then an exact-2x
    ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)`` + BN + ReLU, then
    1x1 to ``n_filters`` + BN + ReLU."""

    def __init__(self, in_channels: int, n_filters: int, device=None):
        super().__init__()
        c4 = in_channels // 4
        self.conv1 = nn.Conv2d(in_channels, c4, 1, device=device)
        self.norm1 = BatchNorm(c4, device=device)
        self.scse = SCSEBlock(c4, device=device)
        self.deconv2 = nn.ConvTranspose2d(c4, c4, 3, stride=2, padding=1, output_padding=1,
                                          device=device)
        self.norm2 = BatchNorm(c4, device=device)
        self.conv3 = nn.Conv2d(c4, n_filters, 1, device=device)
        self.norm3 = BatchNorm(n_filters, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = x + self.scse(x)
        x = torch.relu(self.norm2(self.deconv2(x)))
        return torch.relu(self.norm3(self.conv3(x)))


class CDNetModel(nn.Module):
    """``forward(x, y) -> (N, num_classes, H, W)`` logits."""

    def __init__(self, num_classes: int = 2, layers: Sequence[int] = (3, 4, 6, 3),
                 device=None):
        super().__init__()
        self.firstconv = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.firstbn = BatchNorm(64, device=device)
        inplanes = 64
        for k, (planes, n, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                    (1, 2, 2, 2)), start=1):
            down = stride != 1 or inplanes != planes
            blocks = [SEBasicBlock(inplanes, planes, stride, down, device=device)]
            blocks += [SEBasicBlock(planes, planes, device=device) for _ in range(1, n)]
            setattr(self, f"encoder{k}", nn.Sequential(*blocks))
            inplanes = planes
        self.dblock_master = Dblock(512, device=device)
        for k, (cin, cout) in zip((4, 3, 2, 1), ((512, 256), (256, 128), (128, 64), (64, 64))):
            setattr(self, f"decoder{k}_master", DecoderBlock(cin, cout, device=device))
        self.finaldeconv1_master = nn.ConvTranspose2d(64, 32, 4, 2, 1, device=device)
        self.finalconv2_master = nn.Conv2d(32, 32, 3, padding=1, device=device)
        self.finalconv3_master = nn.Conv2d(32, num_classes, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        h = torch.relu(self.firstbn(self.firstconv(torch.cat([x, y], dim=0))))
        e1 = self.encoder1(max_pool(h, 3, 2, 1))
        e2 = self.encoder2(e1)
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)
        c = self.dblock_master(e4[:n] - e4[n:])
        d4 = self.decoder4_master(c) + e3[:n] - e3[n:]
        d3 = self.decoder3_master(d4) + e2[:n] - e2[n:]
        d2 = self.decoder2_master(d3) + e1[:n] - e1[n:]
        d1 = self.decoder1_master(d2)
        out = torch.relu(self.finaldeconv1_master(d1))
        out = torch.relu(self.finalconv2_master(out))
        return self.finalconv3_master(out)


def CDNet34(num_classes: int = 2, device=None) -> CDNetModel:
    """SE-ResNet-34 layers (3, 4, 6, 3)."""
    return CDNetModel(num_classes, (3, 4, 6, 3), device=device)
