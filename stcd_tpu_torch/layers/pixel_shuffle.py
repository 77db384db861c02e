"""ICNR-initialised sub-pixel (PixelShuffle) upsampling, NCHW (counterpart of
stcd_tpu/layers/pixel_shuffle.py; ref models/pixel_shuffel_up.py: icnr :6-17,
PS_UP :48-54). Not on a live path of the reference, but part of its API."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C*s^2, H, W) -> (N, C, H*s, W*s): output channel c at sub-position
    (dy, dx) reads input channel c*s^2 + dy*s + dx (``nn.PixelShuffle``)."""
    return F.pixel_shuffle(x, scale)


@torch.no_grad()
def icnr_(weight: torch.Tensor, scale: int = 2, generator=None) -> torch.Tensor:
    """ICNR in place on a (O*s^2, I, kH, kW) conv weight: a kernel of O output
    channels, each repeated s^2 times in a row, so that the shuffled output
    starts as a nearest-neighbour upsampling of one conv. The kernel is drawn
    as flax's ``kaiming_normal`` draws it (variance 2 / fan_in, a normal
    truncated at two standard deviations and rescaled to that variance), and
    the JAX ``icnr_init`` repeats along its last (output) axis the same way."""
    o, i, kh, kw = weight.shape
    sub = torch.empty((o // (scale * scale), i, kh, kw))
    nn.init.trunc_normal_(sub, std=1.0, a=-2.0, b=2.0, generator=generator)
    sub *= math.sqrt(2.0 / (i * kh * kw)) / _TRUNC_STD
    weight.copy_(sub.repeat_interleave(scale * scale, dim=0).to(weight))
    return weight


class PSUp(nn.Module):
    """PS_UP (ref :48-54): 3x3 conv to ``out_channels * scale^2`` with ICNR
    init, PixelShuffle(scale), ReLU."""

    def __init__(self, in_channels: int, out_channels: int, scale: int = 2, device=None):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(in_channels, out_channels * scale ** 2, 3, padding=1,
                              device=device)
        icnr_(self.conv.weight, scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(pixel_shuffle(self.conv(x), self.scale))
