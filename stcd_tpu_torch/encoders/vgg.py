"""DSIFN's VGG16 feature extractor on NCHW tensors (counterpart of
stcd_tpu/encoders/vgg.py:28-66 ``VGG16Features``). ``features`` is
torchvision's ``vgg16().features`` up to index 29 under its indices, so a
torchvision state_dict (without its last pool) loads; the taps are the ReLUs
at indices 3, 8, 15, 22 and 29 (relu1_2 .. relu5_3). The smp-contract
``VGGEncoder`` belongs to the smp zoo (ROADMAP.md Queue 1 #9).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

# torchvision vgg16 cfg "D" without its last pool
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512)
TAPS = (3, 8, 15, 22, 29)
OUT_CHANNELS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Module):
    """``forward(x)`` -> [relu1_2, relu2_2, relu3_3, relu4_3, relu5_3] at
    strides (1, 2, 4, 8, 16). No BatchNorm, so no train-time state."""

    def __init__(self, in_channels: int = 3, device=None):
        super().__init__()
        layers: List[nn.Module] = []
        cin = in_channels
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1, device=device), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAPS:
                taps.append(x)
        return taps
