"""DenseNet encoders (counterpart of stcd_tpu/encoders/densenet.py) under
torchvision's names: ``features.conv0``, ``features.norm0``,
``features.denseblock{i}.denselayer{j}.norm1`` / ``conv1`` / ``norm2`` /
``conv2``, ``features.transition{i}.norm`` / ``conv`` and
``features.norm5``.

A stage's skip is taken inside the transition after its BatchNorm and relu
and before its 1x1 conv and 2x2 average pool, so the skip keeps the dense
block's full width while the stream goes on at half of it; stage 5 ends with
norm5 and relu. DenseNet does not dilate (smp's make_dilated refuses it).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm

# name: (init_features, growth_rate, block_config)
_DENSENET_CFGS = {
    "densenet121": (64, 32, (6, 12, 24, 16)),
    "densenet169": (64, 32, (6, 12, 32, 32)),
    "densenet201": (64, 32, (6, 12, 48, 32)),
    "densenet161": (96, 48, (6, 12, 36, 24)),
}


def densenet_out_channels(name: str) -> Tuple[int, ...]:
    init, k, blocks = _DENSENET_CFGS[name]
    chans, c = [3, init], init
    for i, n in enumerate(blocks):
        c += n * k
        chans.append(c)
        if i < len(blocks) - 1:
            c //= 2
    return tuple(chans)


class DenseLayer(nn.Module):
    """BN-relu-conv1x1(4k)-BN-relu-conv3x3(k), concatenated to its input."""

    def __init__(self, in_c: int, growth_rate: int, bn_size: int = 4, device=None):
        super().__init__()
        self.norm1 = BatchNorm(in_c, device=device)
        self.conv1 = nn.Conv2d(in_c, bn_size * growth_rate, 1, bias=False, device=device)
        self.norm2 = BatchNorm(bn_size * growth_rate, device=device)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(torch.relu(self.norm1(x)))
        h = self.conv2(torch.relu(self.norm2(h)))
        return torch.cat([x, h], 1)


class _Transition(nn.Module):
    def __init__(self, in_c: int, device=None):
        super().__init__()
        self.norm = BatchNorm(in_c, device=device)
        self.conv = nn.Conv2d(in_c, in_c // 2, 1, bias=False, device=device)


class DenseNetEncoder(nn.Module):
    """smp-contract DenseNet (stcd_tpu/encoders/densenet.py:82-122):
    [x, conv0-norm0-relu (/2), pool + block1 + T1 skip (/4), block2 + T2
    skip, block3 + T3 skip, block4 + norm5 (/32)]."""

    head_prefixes = ("classifier.",)

    def __init__(self, arch: str = "densenet121", depth: int = 5, in_channels: int = 3,
                 device=None):
        super().__init__()
        init, k, blocks = _DENSENET_CFGS[arch]
        self.depth = depth
        self.out_channels = densenet_out_channels(arch)[:depth + 1]
        f = nn.ModuleDict()
        if depth >= 1:
            f["conv0"] = nn.Conv2d(in_channels, init, 7, stride=2, padding=3, bias=False,
                                   device=device)
            f["norm0"] = BatchNorm(init, device=device)
        c = init
        for i, n in enumerate(blocks):
            if depth < 2 + i:
                break
            block = nn.Module()
            for j in range(n):
                block.add_module(f"denselayer{j + 1}", DenseLayer(c + j * k, k, device=device))
            f[f"denseblock{i + 1}"] = block
            c += n * k
            if i < len(blocks) - 1:
                f[f"transition{i + 1}"] = _Transition(c, device)
                c //= 2
            else:
                f["norm5"] = BatchNorm(c, device=device)
        self.features = f
        self._n_blocks = len(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        f = self.features
        features = [x]
        if self.depth >= 1:
            h = torch.relu(f["norm0"](f["conv0"](x)))
            features.append(h)
        for i in range(self._n_blocks):
            if self.depth < 2 + i:
                break
            if i == 0:
                h = F.max_pool2d(h, 3, 2, 1)
            for layer in f[f"denseblock{i + 1}"].children():
                h = layer(h)
            if i < self._n_blocks - 1:
                t = f[f"transition{i + 1}"]
                h = torch.relu(t.norm(h))
                features.append(h)
                h = F.avg_pool2d(t.conv(h), 2, 2)
            else:
                h = torch.relu(f["norm5"](h))
                features.append(h)
        return features
