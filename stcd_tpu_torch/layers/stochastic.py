"""Train-time randomness with an explicit generator.

The JAX package threads one ``dropout`` key stream through a model's
stochastic layers. Here every such layer is a ``Stochastic`` module that
draws from ``self.generator``, a ``torch.Generator`` on the model's device
that the train step owns and hands over with ``set_generator``; ``None``
means PyTorch's global generator of that device. All draws are made on the
generator's device and stay there: none is read on the host.

In data-parallel training (``parallel.distributed``) every rank holds the
same generator and a ``RowMap`` of its rows in the global batch: a layer
then draws its mask for the global batch, as the JAX layer does on the
global array, and keeps its rank's rows. So W ranks draw what one process
draws on the global batch, for row-major and channels_last layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


class RowMap(NamedTuple):
    """Where a rank's rows sit in the global batch. A tensor whose batch is k
    blocks of ``local`` rows (the step's rows, concatenated k times, as SegCD
    folds A and B) has row j of block q at global row
    ``q * n_global + rows[j]`` of k blocks of ``n_global``. ``off`` and
    ``stride`` say the same of the strided split ``rows = off + stride *
    arange(local)``, ``n_global = stride * local``, where a local row J of
    any block is global row ``off + stride * J``: the attention kernels'
    dropout hash reads them (``ops/attention.py``, ``dropout_rows``)."""

    local: int
    n_global: int
    rows: torch.Tensor  # (local,) int64, on the model's device
    off: int = 0
    stride: int = 1

    def take(self, draw, n: int) -> torch.Tensor:
        """``draw(m)`` makes a mask of m rows: the rows of the global batch's
        mask that this rank's ``n``-row input holds."""
        if n % self.local:
            raise ValueError(f"a batch of {n} rows is no whole number of the step's "
                             f"{self.local} rows: its global rows are unknown")
        k = n // self.local
        full = draw(k * self.n_global)
        blocks = torch.arange(k, device=full.device)[:, None] * self.n_global
        return full.index_select(0, (blocks + self.rows.to(full.device)).reshape(-1))


class Stochastic(nn.Module):
    """A module whose train-mode forward draws from ``self.generator``,
    for the global batch when it has a ``RowMap`` (``self.rows``)."""

    generator: Optional[torch.Generator] = None
    rows: Optional[RowMap] = None

    def bernoulli(self, x: torch.Tensor, shape: tuple, keep: float) -> torch.Tensor:
        """A mask of ``shape`` (x's batch first, in x's dtype and on its device)
        whose elements are 1 with probability ``keep``; laid out channels_last
        where ``shape`` is that of a channels_last ``x``."""
        fmt = torch.contiguous_format
        if (tuple(shape) == tuple(x.shape) and x.dim() == 4 and not x.is_contiguous()
                and x.is_contiguous(memory_format=torch.channels_last)):
            fmt = torch.channels_last

        def draw(n: int) -> torch.Tensor:
            if n == x.shape[0] and tuple(shape) == tuple(x.shape):
                out = torch.empty_like(x)
            else:
                out = torch.empty((n, *shape[1:]), device=x.device, dtype=x.dtype,
                                  memory_format=fmt)
            return out.bernoulli_(keep, generator=self.generator)

        return draw(shape[0]) if self.rows is None else self.rows.take(draw, shape[0])


def set_generator(model: nn.Module, generator: Optional[torch.Generator],
                  rows: Optional[RowMap] = None) -> nn.Module:
    """Point every stochastic layer of ``model`` at ``generator`` and at the
    ``RowMap`` of a data-parallel step (None: the batch is the whole batch)."""
    for mod in model.modules():
        if isinstance(mod, Stochastic):
            mod.generator = generator
            mod.rows = rows
    return model


class Dropout(Stochastic):
    """Inverted dropout (flax ``nn.Dropout``): in training each element is
    kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``; identity
    in eval or at ``p == 0``. ``columns`` = (full width, indices) marks ``x``
    as a block of the last axis of a wider activation (a tensor-parallel
    rank's hidden channels): the mask is drawn for the full width and the
    block's columns kept, so the ranks of a model group together drop what
    one process drops."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor, columns=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if columns is None:
            return x * self.bernoulli(x, x.shape, keep) / keep
        width, index = columns
        mask = self.bernoulli(x, (*x.shape[:-1], width), keep).index_select(-1, index)
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
        return x * self.bernoulli(x, (x.shape[0],) + (1,) * (x.dim() - 1), keep) / keep


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One uniform uint32 as an int64 tensor on ``device``, for a kernel that
    reads its seed there (the JAX side draws ``jax.random.bits`` per block)."""
    return torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=device,
                         generator=generator)
