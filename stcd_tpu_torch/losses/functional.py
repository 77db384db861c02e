"""Loss functions of the STCD training steps and of the trainer (counterpart
of stcd_tpu/losses/functional.py). The binary losses and ``contrastive_loss``
take probabilities (sigmoid outputs) and targets of one shape; the class
losses (``cross_entropy``, ``focal_loss``, ``miou_loss``, ``mmiou_loss``) take
NCHW logits, where the JAX functions take NHWC, and integer targets. All
compute in float32.

Under a process group of W > 1 ranks each rank holds rows of the global
batch, and the losses that are ratios of batch sums (``dice_loss``,
``cross_entropy``, ``contrastive_loss``) sum those over the ranks
(``parallel.distributed.all_reduce_sum``), so each rank gets the global
loss, as the JAX functions do on a batch sharded over the mesh. The losses
that are means of per-sample terms (``bce_loss``, ``focal_loss``, ...) stay
local: the mean of the ranks' gradients makes them global."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stcd_tpu_torch.layers.modules import resize_bilinear
from stcd_tpu_torch.parallel.distributed import all_reduce_sum

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
    """Soft Dice over the whole (global) batch."""
    p = probs.float().reshape(-1)
    t = target.float().reshape(-1)
    intersection, p_sum, t_sum = all_reduce_sum(
        torch.stack([torch.sum(p * t), torch.sum(p), torch.sum(t)]))
    return 1.0 - (2.0 * intersection + smooth) / (p_sum + t_sum + smooth)


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
    total, denom = all_reduce_sum(torch.stack([total, denom]))
    return total / torch.clamp(denom, min=_EPS)


def _class_last(logits: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> (N, ..., C) float32."""
    return logits.float().movedim(1, -1)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha=None, gamma: float = 1.0,
               balance_index: int = 0, smooth: float = 1e-5,
               apply_nonlin: bool = True) -> torch.Tensor:
    """Focal loss over softmax probabilities (stcd_tpu/losses/functional.py:104-147).

    logits: (N, C, H, W); target: an integer map of N * H * W elements. Ids
    outside [0, C) fold to class 0, as in the JAX function. ``alpha``: None
    for ones; a length-C sequence is normalised and inverted (inverse class
    frequency); a float puts ``alpha`` on ``balance_index`` and spreads
    ``1 - alpha`` over the other classes. With ``smooth`` the one-hot target is
    clipped to [smooth / (C - 1), 1 - smooth]."""
    num_class = logits.shape[1]
    p = _class_last(logits)
    if apply_nonlin:
        p = torch.softmax(p, dim=-1)
    p = p.reshape(-1, num_class)
    t = target.reshape(-1).to(torch.int64)
    t = torch.where((t < 0) | (t >= num_class), torch.zeros_like(t), t)

    if alpha is None:
        alpha_v = torch.ones(num_class, dtype=torch.float32, device=p.device)
    else:
        alpha_arr = torch.as_tensor(alpha, dtype=torch.float32, device=p.device)
        if alpha_arr.dim() == 0:
            alpha_v = ((1.0 - alpha_arr) / max(num_class - 1, 1)).repeat(num_class)
            alpha_v[balance_index] = alpha_arr
        else:
            alpha_v = 1.0 / (alpha_arr / alpha_arr.sum())

    one_hot = F.one_hot(t, num_class).to(torch.float32)
    if smooth:
        one_hot = torch.clamp(one_hot, smooth / (num_class - 1), 1.0 - smooth)
    pt = torch.sum(one_hot * p, dim=1) + smooth
    loss = -alpha_v[t] * torch.pow(1.0 - pt, gamma) * torch.log(pt)
    return loss.mean()


def _soft_iou_terms(logits: torch.Tensor, target: torch.Tensor, n_classes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft intersection and union per image and class, (N, C) each. A target
    id outside [0, C) has an all-zero one-hot row, as ``jax.nn.one_hot`` gives."""
    n = logits.shape[0]
    p = torch.softmax(_class_last(logits), dim=-1).reshape(n, -1, n_classes)
    t = target.reshape(n, -1).to(torch.int64)
    valid = (t >= 0) & (t < n_classes)
    one_hot = F.one_hot(torch.where(valid, t, torch.zeros_like(t)), n_classes)
    one_hot = one_hot.to(torch.float32) * valid[..., None]
    inter = torch.sum(p * one_hot, dim=1)
    union = torch.sum(p + one_hot - p * one_hot, dim=1)
    return inter, union


def miou_loss(logits: torch.Tensor, target: torch.Tensor, weight=None,
              n_classes: int = 2) -> torch.Tensor:
    """-mean(w * inter / union) (stcd_tpu/losses/functional.py:163-168)."""
    inter, union = _soft_iou_terms(logits, target, n_classes)
    if weight is None:
        w = torch.ones(n_classes, dtype=torch.float32, device=inter.device)
    else:
        w = torch.as_tensor(weight, dtype=torch.float32, device=inter.device)
    return -torch.mean(w * inter / (union + _EPS))


def mmiou_loss(logits: torch.Tensor, target: torch.Tensor, n_classes: int = 2
               ) -> torch.Tensor:
    """-min(iou) - mean(iou) (stcd_tpu/losses/functional.py:171-175)."""
    inter, union = _soft_iou_terms(logits, target, n_classes)
    iou = inter / (union + _EPS)
    return -torch.min(iou) - torch.mean(iou)


def contrastive_loss(pred: torch.Tensor, cd_label: torch.Tensor,
                     pse_label: torch.Tensor) -> torch.Tensor:
    """Pixel consistency loss between the two halves of a concatenated batch
    (stcd_tpu/losses/functional.py:178-198).

    ``pred`` holds the sigmoid change maps of 2n pairs; ``cd_label`` and
    ``pse_label`` are the labels of its first and second n. Where the two
    labels agree the second half's prediction is pulled toward the first
    half's, where they disagree toward one minus it. The stage-3 step passes
    the synthesized pairs first and the real pairs second."""
    n = cd_label.shape[0]
    cd_pred = pred[:n].float()
    pse_pred = pred[n:].float()
    agree = (cd_label == pse_label).to(torch.float32)
    disagree = 1.0 - agree
    se_pos = (pse_pred - cd_pred) ** 2
    se_neg = (pse_pred - torch.abs(cd_pred - 1.0)) ** 2
    pos, n_agree, neg, n_disagree = all_reduce_sum(torch.stack([
        torch.sum(se_pos * agree), torch.sum(agree), torch.sum(se_neg * disagree),
        torch.sum(disagree)]))
    return pos / (n_agree + _EPS) + neg / (n_disagree + _EPS)


def get_alpha(loader) -> np.ndarray:
    """Class-occurrence counts over a labelled loader, float64
    (stcd_tpu/losses/functional.py:201-221): any iterable of batches with a
    ``label`` (or ``L``) entry; 255 folds into class 0."""
    counts = None
    for batch in loader:
        lab = batch["label"] if "label" in batch else batch["L"]
        if isinstance(lab, torch.Tensor):
            lab = lab.cpu().numpy()
        lab = np.asarray(lab).astype(np.int64)
        lab[lab == 255] = 0
        c = np.bincount(lab.reshape(-1))
        if counts is None:
            counts = c.astype(np.float64)
        else:
            if len(c) > len(counts):
                counts = np.pad(counts, (0, len(c) - len(counts)))
            counts[: len(c)] += c
    return counts
