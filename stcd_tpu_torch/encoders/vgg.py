"""VGG encoders on NCHW tensors (counterpart of stcd_tpu/encoders/vgg.py).

- ``VGG16Features`` (:28-66): DSIFN's feature extractor. ``features`` is
  torchvision's ``vgg16().features`` up to index 29 under its indices, so a
  torchvision state_dict (without its last pool) loads; the taps are the
  ReLUs at indices 3, 8, 15, 22 and 29 (relu1_2 .. relu5_3).
- ``VGGEncoder`` (:67-129): smp's stage contract over vgg11/13/16/19 and
  their ``_bn`` variants. ``features`` is torchvision's ``make_layers`` under
  its indices (smp's encoder is torchvision's VGG without the classifier).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm

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


# torchvision's configs A, B, D and E
_VGG_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"),
}


def vgg_out_channels(name: str) -> Tuple[int, ...]:
    return (64, 128, 256, 512, 512, 512)


class VGGEncoder(nn.Module):
    """``forward(x)`` -> ``depth + 1`` levels: the conv stages, each split
    before a max pool (the first at input resolution), and at depth 5 the last
    pool alone (/32). Below depth 5 the layers after stage ``depth`` are not
    built, as in the JAX encoder. The convs keep their bias in the ``_bn``
    variants too, as torchvision's do. The ``_bn`` BatchNorm is the port's
    (``layers/norm.py``). It has no dilated mode."""

    def __init__(self, arch: str = "vgg16", batch_norm: bool = False, depth: int = 5,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.depth = depth
        self.out_channels = vgg_out_channels(arch)[:depth + 1]
        cfg = list(_VGG_CFGS[arch])
        if depth < 5:  # up to the stage ``depth``, without the pool after it
            cfg = cfg[:[i for i, v in enumerate(cfg) if v == "M"][depth]]
        layers: List[nn.Module] = []
        cin = in_channels
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers.append(nn.Conv2d(cin, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(BatchNorm(v, device=device))
            layers.append(nn.ReLU())
            cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = []
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                features.append(x)
            x = layer(x)
        features.append(x)  # the last stage, or at depth 5 the last pool alone
        return features
