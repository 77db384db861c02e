"""Loss functions of the STCD training steps (counterpart of
stcd_tpu/losses/functional.py:28-65). They take probabilities (sigmoid
outputs) and targets of one shape and compute in float32."""

from __future__ import annotations

import torch

_LOG_GUARD = 1.2e-38  # a normal float32: log never sees 0, so the gradient stays finite


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log clamped at -100 as torch's BCELoss clamps it, with a finite
    (zero) gradient where x underflowed to 0."""
    log = torch.clamp(torch.log(torch.clamp(x, min=_LOG_GUARD)), min=-100.0)
    return torch.where(x < _LOG_GUARD, torch.full_like(x, -100.0), log)


def bce_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities. It is written out, and
    is not ``F.binary_cross_entropy``, so that value and gradient at
    saturated sigmoids (exactly 0 or 1) are those of the JAX function."""
    p = probs.float()
    t = target.float()
    return -torch.mean(t * _safe_log(p) + (1.0 - t) * _safe_log(1.0 - p))


def dice_loss(probs: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice over the whole batch."""
    p = probs.float().reshape(-1)
    t = target.float().reshape(-1)
    intersection = torch.sum(p * t)
    return 1.0 - (2.0 * intersection + smooth) / (torch.sum(p) + torch.sum(t) + smooth)


def bce_dice(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return bce_loss(probs, target) + dice_loss(probs, target)


def cd_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The same terms as ``bce_dice``."""
    return dice_loss(probs, target) + bce_loss(probs, target)
