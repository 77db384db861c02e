"""Shared layer helpers (counterpart of stcd_tpu/layers/modules.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
