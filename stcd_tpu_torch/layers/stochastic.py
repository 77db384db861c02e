"""Train-time randomness with an explicit generator.

The JAX package threads one ``dropout`` key stream through a model's
stochastic layers. Here every such layer is a ``Stochastic`` module that
draws from ``self.generator``, a ``torch.Generator`` on the model's device
that the train step owns and hands over with ``set_generator``; ``None``
means PyTorch's global generator of that device. All draws are made on the
generator's device and stay there: none is read on the host.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Stochastic(nn.Module):
    """A module whose train-mode forward draws from ``self.generator``."""

    generator: Optional[torch.Generator] = None


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Point every stochastic layer of ``model`` at ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Stochastic):
            mod.generator = generator
    return model


class Dropout(Stochastic):
    """Inverted dropout (flax ``nn.Dropout``): in training each element is
    kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``; identity
    in eval or at ``p == 0``."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


class DropPath(Stochastic):
    """Per-sample stochastic depth in training; identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device,
                           dtype=x.dtype).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One uniform uint32 as an int64 tensor on ``device``, for a kernel that
    reads its seed there (the JAX side draws ``jax.random.bits`` per block)."""
    return torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=device,
                         generator=generator)
