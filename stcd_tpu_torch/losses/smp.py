"""The segmentation_models_pytorch loss family (counterpart of
stcd_tpu/losses/smp.py): Dice, Jaccard, Tversky, Focal, SoftBCEWithLogits,
SoftCrossEntropy, MCC and Lovasz, as plain callables whose gradients go
through autograd.

NCHW, as smp has it. Modes: 'binary' takes (N, 1, H, W) or (N, H, W) logits
and a 0/1 target of (N, H, W) or (N, 1, H, W); 'multiclass' takes
(N, C, H, W) logits and an (N, H, W) integer target; 'multilabel' takes
(N, C, H, W) logits and a per-channel 0/1 target of the same shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BINARY_MODE = "binary"
MULTICLASS_MODE = "multiclass"
MULTILABEL_MODE = "multilabel"

_EPS = 1e-7


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> (C, N * ...): a row a class."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def _flatten_by_mode(y_pred: torch.Tensor, y_true: torch.Tensor, mode: str,
                     from_logits: bool, ignore_index: Optional[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probabilities, targets, valid) as (C, N * H * W): every class's pixels of
    the whole batch in one row, as smp's dice reduces over dims (0, 2)."""
    if mode == BINARY_MODE:
        if y_pred.dim() == y_true.dim() + 1:
            y_pred = y_pred[:, 0]
        p = torch.sigmoid(y_pred) if from_logits else y_pred
        p = p.reshape(1, -1).float()
        t = y_true.reshape(1, -1).float()
        valid = torch.ones_like(t) if ignore_index is None else (
            y_true.reshape(1, -1) != ignore_index).float()
        return p * valid, t * valid, valid
    if mode == MULTICLASS_MODE:
        c = y_pred.shape[1]
        p = torch.softmax(y_pred, dim=1) if from_logits else y_pred
        p = _channels_first(p).float()
        tt = y_true.reshape(-1).long()
        valid_row = torch.ones_like(tt, dtype=torch.float32) if ignore_index is None else (
            tt != ignore_index).float()
        oh = F.one_hot(torch.where(valid_row > 0, tt, 0), c).T.float() * valid_row[None, :]
        return p * valid_row[None, :], oh, valid_row[None, :].expand_as(oh)
    if mode == MULTILABEL_MODE:
        p = torch.sigmoid(y_pred) if from_logits else y_pred
        p = _channels_first(p).float()
        t = _channels_first(y_true).float()
        valid = torch.ones_like(t)
        if ignore_index is not None:
            valid = (_channels_first(y_true) != ignore_index).float()
            t = t * valid
        return p * valid, t, valid
    raise ValueError(f"unknown mode {mode}")


def _aggregate_classwise(loss_per_class: torch.Tensor, t_sums: torch.Tensor,
                         classes: Optional[Sequence[int]]) -> torch.Tensor:
    """Zero the classes absent from the target, select ``classes``, mean."""
    loss_per_class = loss_per_class * (t_sums > 0).float()
    if classes is not None:
        loss_per_class = loss_per_class[torch.as_tensor(classes, device=t_sums.device)]
    return loss_per_class.mean()


def _score_to_loss(score: torch.Tensor, log_loss: bool, eps: float) -> torch.Tensor:
    return -torch.log(torch.clamp(score, min=eps)) if log_loss else 1.0 - score


@dataclasses.dataclass
class DiceLoss:
    """Soft dice a class, the mean over the classes present in the target."""

    mode: str = BINARY_MODE
    classes: Optional[Sequence[int]] = None
    log_loss: bool = False
    from_logits: bool = True
    smooth: float = 0.0
    eps: float = _EPS
    ignore_index: Optional[int] = None

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        p, t, _ = _flatten_by_mode(y_pred, y_true, self.mode, self.from_logits,
                                   self.ignore_index)
        inter = (p * t).sum(1)
        card = p.sum(1) + t.sum(1)
        score = (2 * inter + self.smooth) / torch.clamp(card + self.smooth, min=self.eps)
        return _aggregate_classwise(_score_to_loss(score, self.log_loss, self.eps), t.sum(1),
                                    self.classes)


@dataclasses.dataclass
class JaccardLoss:
    """Soft IoU."""

    mode: str = BINARY_MODE
    classes: Optional[Sequence[int]] = None
    log_loss: bool = False
    from_logits: bool = True
    smooth: float = 0.0
    eps: float = _EPS

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        p, t, _ = _flatten_by_mode(y_pred, y_true, self.mode, self.from_logits, None)
        inter = (p * t).sum(1)
        union = p.sum(1) + t.sum(1) - inter
        score = (inter + self.smooth) / torch.clamp(union + self.smooth, min=self.eps)
        return _aggregate_classwise(_score_to_loss(score, self.log_loss, self.eps), t.sum(1),
                                    self.classes)


@dataclasses.dataclass
class TverskyLoss:
    """Dice with the false positives weighted by ``alpha`` and the false
    negatives by ``beta``; ``gamma`` is a power of the mean over classes."""

    mode: str = BINARY_MODE
    classes: Optional[Sequence[int]] = None
    log_loss: bool = False
    from_logits: bool = True
    smooth: float = 0.0
    eps: float = _EPS
    alpha: float = 0.5
    beta: float = 0.5
    gamma: float = 1.0

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        p, t, _ = _flatten_by_mode(y_pred, y_true, self.mode, self.from_logits, None)
        tp = (p * t).sum(1)
        fp = (p * (1 - t)).sum(1)
        fn = ((1 - p) * t).sum(1)
        score = (tp + self.smooth) / torch.clamp(
            tp + self.alpha * fp + self.beta * fn + self.smooth, min=self.eps)
        return _aggregate_classwise(_score_to_loss(score, self.log_loss, self.eps), t.sum(1),
                                    self.classes) ** self.gamma


def focal_loss_with_logits(output: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
                           alpha: Optional[float] = 0.25, reduction: str = "mean",
                           normalized: bool = False, reduced_threshold: Optional[float] = None,
                           ignore_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """smp's losses/_functional.py focal loss, log-probabilities clamped at -100."""
    target = target.to(output.dtype)
    logpt = -(torch.clamp(F.logsigmoid(output), min=-100.0) * target
              + torch.clamp(F.logsigmoid(-output), min=-100.0) * (1 - target))
    pt = torch.exp(-logpt)
    if reduced_threshold is None:
        focal_term = (1.0 - pt) ** gamma
    else:
        focal_term = ((1.0 - pt) / reduced_threshold) ** gamma
        focal_term = torch.where(pt < reduced_threshold, torch.ones_like(focal_term), focal_term)
    loss = focal_term * logpt
    if alpha is not None:
        loss = loss * (alpha * target + (1 - alpha) * (1 - target))
    if ignore_mask is not None:
        loss = loss * ignore_mask
    if normalized:
        norm = focal_term if ignore_mask is None else focal_term * ignore_mask
        loss = loss / torch.clamp(norm.sum(), min=_EPS)
    if reduction == "mean":
        if ignore_mask is not None:
            return loss.sum() / torch.clamp(ignore_mask.sum(), min=1.0)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@dataclasses.dataclass
class FocalLoss:
    """Sigmoid focal loss; in multiclass mode the sum over classes of each
    class against the rest."""

    mode: str = BINARY_MODE
    alpha: Optional[float] = None
    gamma: float = 2.0
    ignore_index: Optional[int] = None
    reduction: str = "mean"
    normalized: bool = False
    reduced_threshold: Optional[float] = None

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        kw = dict(gamma=self.gamma, alpha=self.alpha, reduction=self.reduction,
                  normalized=self.normalized, reduced_threshold=self.reduced_threshold)
        if self.mode in (BINARY_MODE, MULTILABEL_MODE):
            if self.mode == BINARY_MODE and y_pred.dim() == y_true.dim() + 1:
                y_pred = y_pred[:, 0]
            out, tgt = y_pred.reshape(-1), y_true.reshape(-1)
            mask = None
            if self.ignore_index is not None:
                mask = (tgt != self.ignore_index).float()
                tgt = torch.where(mask > 0, tgt, torch.zeros_like(tgt))
            return focal_loss_with_logits(out, tgt, ignore_mask=mask, **kw)
        t = y_true.long()
        mask = None
        if self.ignore_index is not None:
            mask = (t != self.ignore_index).float().reshape(-1)
        total = 0.0
        for cls in range(y_pred.shape[1]):
            total = total + focal_loss_with_logits(
                y_pred[:, cls].reshape(-1), (t == cls).float().reshape(-1), ignore_mask=mask,
                **kw)
        return total


@dataclasses.dataclass
class SoftBCEWithLogitsLoss:
    """BCE with logits, label smoothing and an ignored target value."""

    weight: Optional[torch.Tensor] = None
    ignore_index: Optional[int] = -100
    reduction: str = "mean"
    smooth_factor: Optional[float] = None
    pos_weight: Optional[torch.Tensor] = None

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        y_true_f = y_true.float()
        soft = y_true_f if self.smooth_factor is None else (
            (1 - y_true_f) * self.smooth_factor + y_true_f * (1 - self.smooth_factor))
        logp = torch.clamp(F.logsigmoid(y_pred), min=-100.0)
        log1mp = torch.clamp(F.logsigmoid(-y_pred), min=-100.0)
        pw = 1.0 if self.pos_weight is None else self.pos_weight
        loss = -(pw * soft * logp + (1 - soft) * log1mp)
        if self.weight is not None:
            loss = loss * self.weight
        if self.ignore_index is not None:
            loss = loss * (y_true != self.ignore_index).float()
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss


@dataclasses.dataclass
class SoftCrossEntropyLoss:
    """Label-smoothed cross-entropy over the class axis ``dim`` with an ignored
    target value; the mean runs over every position, ignored ones included."""

    reduction: str = "mean"
    smooth_factor: float = 0.0
    ignore_index: Optional[int] = -100
    dim: int = 1

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(y_pred.float(), dim=self.dim)
        t = y_true.long()
        valid = torch.ones(t.shape, device=t.device) if self.ignore_index is None else (
            t != self.ignore_index).float()
        safe_t = torch.where(valid > 0, t, torch.zeros_like(t))
        nll = -logp.gather(self.dim, safe_t.unsqueeze(self.dim)).squeeze(self.dim)
        smooth_loss = -logp.mean(dim=self.dim)
        sf = self.smooth_factor
        loss = ((1 - sf) * nll + sf * smooth_loss) * valid
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss


@dataclasses.dataclass
class MCCLoss:
    """1 - the Matthews correlation of probabilities and a binary target."""

    eps: float = 1e-5

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        bs = y_true.shape[0]
        t = y_true.reshape(bs, -1).float()
        p = y_pred.reshape(bs, -1).float()
        tp = (p * t).sum() + self.eps
        tn = ((1 - p) * (1 - t)).sum() + self.eps
        fp = (p * (1 - t)).sum() + self.eps
        fn = ((1 - p) * t).sum() + self.eps
        numerator = tp * tn - fp * fn
        denominator = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return 1.0 - numerator / denominator


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def _sort_descending(errors: torch.Tensor):
    return torch.sort(errors, descending=True, stable=True)


def _lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    errors = 1.0 - logits * (2.0 * labels - 1.0)
    errors_sorted, order = _sort_descending(errors)
    return (torch.relu(errors_sorted) * _lovasz_grad(labels[order])).sum()


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """classes='present': a class absent from the batch adds nothing, and the
    mean runs over the present classes."""
    losses, present = [], []
    for cls in range(probas.shape[1]):
        fg = (labels == cls).float()
        errors_sorted, order = _sort_descending(torch.abs(fg - probas[:, cls]))
        losses.append((errors_sorted * _lovasz_grad(fg[order])).sum())
        present.append(fg.sum() > 0)
    present = torch.stack(present).float()
    return (torch.stack(losses) * present).sum() / torch.clamp(present.sum(), min=1.0)


@dataclasses.dataclass
class LovaszLoss:
    """The Lovasz hinge (binary, multilabel) or Lovasz softmax (multiclass)
    over the whole batch (per_image=False)."""

    mode: str = BINARY_MODE
    from_logits: bool = True

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        if self.mode in (BINARY_MODE, MULTILABEL_MODE):
            return _lovasz_hinge_flat(y_pred.reshape(-1), y_true.reshape(-1).float())
        probas = torch.softmax(y_pred, dim=1) if self.from_logits else y_pred
        c = probas.shape[1]
        return _lovasz_softmax_flat(probas.movedim(1, -1).reshape(-1, c),
                                    y_true.reshape(-1).long())
