"""Shared layer helpers (counterpart of stcd_tpu/layers/modules.py)."""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import Stochastic


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """Max pool of an NCHW tensor (stcd_tpu/layers/modules.py:39-55): the
    padding counts as -inf, as in ``F.max_pool2d`` and the JAX
    ``reduce_window``."""
    return F.max_pool2d(x, window, stride, padding)


class Dropout2d(Stochastic):
    """Channel dropout (stcd_tpu/layers/modules.py:338-349, torch
    ``nn.Dropout2d``): in training each (sample, channel) map is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; identity in eval or
    at ``p == 0``. The mask is drawn from ``self.generator``."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty(x.shape[:2] + (1,) * (x.dim() - 2), device=x.device,
                           dtype=x.dtype).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


def pad_replicate_to(x: torch.Tensor, size) -> torch.Tensor:
    """Replication pad of an NCHW tensor at the bottom and right up to
    ``size`` = (H, W) (stcd_tpu/layers/modules.py:112-123); a no-op at
    power-of-two sizes."""
    dh, dw = size[0] - x.shape[2], size[1] - x.shape[3]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (0, dw, 0, dh), mode="replicate")


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
