"""Loss functions of the STCD training steps (counterpart of
stcd_tpu/losses/functional.py:28-101). The binary losses take probabilities
(sigmoid outputs) and targets of one shape; ``cross_entropy`` takes NCHW
logits and integer targets. All compute in float32."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stcd_tpu_torch.layers.modules import resize_bilinear

_EPS = 1e-8

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


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = 255) -> torch.Tensor:
    """Mean cross-entropy over the pixels whose target is not
    ``ignore_index`` (stcd_tpu/losses/functional.py:68-101).

    logits: (N, C, H, W); target: (N, H, W) or (N, 1, H, W), any integer or
    float dtype holding class indices. Logits of another size are resized
    bilinearly to the target's (align_corners=True). With per-class
    ``weight`` the mean is the weighted one of ``F.cross_entropy``; when every
    pixel is ignored the loss is 0, as in the JAX function."""
    if target.dim() == 4:
        target = target[:, 0]
    target = target.to(torch.int64)
    if logits.shape[2:] != target.shape[1:]:
        logits = resize_bilinear(logits, tuple(target.shape[1:]), align_corners=True)
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
    total = F.cross_entropy(logits.float(), target, weight=weight,
                            ignore_index=ignore_index, reduction="sum")
    valid = target != ignore_index
    if weight is None:
        denom = valid.sum().to(torch.float32)
    else:
        denom = (weight[torch.where(valid, target, 0)] * valid).sum()
    return total / torch.clamp(denom, min=_EPS)
