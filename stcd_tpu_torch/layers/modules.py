"""Shared layer helpers (counterpart of stcd_tpu/layers/modules.py)."""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` = (H, W)
    (stcd_tpu/layers/modules.py:74-109, which works on NHWC).

    ``align_corners=True`` samples at i * (h - 1) / (H - 1), the grid the JAX
    function builds by hand. ``align_corners=False`` is
    ``F.interpolate(mode="bilinear")``; the JAX function calls
    ``jax.image.resize(method="linear")`` there, which is the same for
    upsampling but anti-aliases when it downsamples, and torch does not.
    The ChangeFormerV6 decoder only upsamples."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest upsample of an NCHW tensor by an integer factor
    (stcd_tpu/layers/modules.py:63-71)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


_ACTIVATIONS = {
    None: lambda x: x,
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=1),  # the channel axis of NCHW
    "softmax2d": lambda x: torch.softmax(x, dim=1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=1),
    "tanh": torch.tanh,
    "argmax": lambda x: torch.argmax(x),
    "argmax2d": lambda x: torch.argmax(x, dim=1),
    "clamp": lambda x: torch.clamp(x, 0, 1),
    "relu": torch.relu,
}


def Activation(name: Union[str, Callable, None]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name (stcd_tpu/layers/modules.py:145-154). Returns a
    callable; the channel axis is 1 (NCHW)."""
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Activation should be callable/sigmoid/softmax/logsoftmax/tanh/"
            f"argmax/argmax2d/clamp/None; got {name}")
    return _ACTIVATIONS[name]


class ConvBNReLU(nn.Sequential):
    """Conv2d + (BatchNorm) + ReLU under smp's Conv2dReLU names: ``0`` is the
    conv, ``1`` the BatchNorm (stcd_tpu/layers/modules.py:171-216). The conv
    has no bias when the BatchNorm is on."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, use_batchnorm: bool = True,
                 device=None):
        if use_batchnorm == "inplace":
            raise ValueError("use_batchnorm='inplace' (InPlaceABN) is not ported; use "
                             "plain batchnorm, and remat=True to save activation memory")
        conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=not use_batchnorm, device=device)
        layers = [conv]
        if use_batchnorm:
            layers.append(BatchNorm(out_channels, device=device))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(super().forward(x))


class SegmentationHead(nn.Sequential):
    """3x3 conv head + optional bilinear upsample (align_corners=True) +
    activation, under smp's names: ``0`` is the conv
    (stcd_tpu/layers/modules.py:289-312)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 activation: Union[str, Callable, None] = None, upsampling: int = 1,
                 device=None):
        super().__init__(nn.Conv2d(in_channels, out_channels, kernel_size,
                                   padding=kernel_size // 2, device=device))
        self.upsampling = upsampling
        self.activation = Activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.upsampling > 1:
            h, w = x.shape[2:]
            x = resize_bilinear(x, (h * self.upsampling, w * self.upsampling),
                                align_corners=True)
        return self.activation(x)
