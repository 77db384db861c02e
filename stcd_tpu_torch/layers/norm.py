"""BatchNorm with the JAX package's semantics (stcd_tpu/layers/norm.py:39-67).

It differs from ``torch.nn.BatchNorm2d`` in three ways, all on purpose:

- the moments are taken in float32 whatever the input dtype, as
  var = E[x^2] - E[x]^2 (clamped at 0);
- the running variance is updated with that biased variance (torch uses
  the unbiased n/(n-1) form);
- the running update uses flax's momentum: new = 0.9 * old + 0.1 * batch.

The normalisation is applied as ``x * w + b`` with per-channel float32
coefficients cast to the input's dtype. The state_dict names are those of
``nn.BatchNorm2d`` (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``), so the original reference's checkpoints load.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Over NCHW input (or any (N, C, ...) layout)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp(xf.square().mean(axes) - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1.0 - self.momentum) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        w = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * w
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * w.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
