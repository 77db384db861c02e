"""smp's functional metric suite (counterpart of stcd_tpu/metrics/functional.py):
``get_stats`` returns per-image, per-class (tp, fp, fn, tn) counts, and the
derived metrics reduce them micro, macro, weighted, imagewise or not at all.

NCHW, as smp has it: binary and multilabel outputs and targets are
(N, C, ...); multiclass ones are (N, ...) integer class maps. The counts are
``torch.long`` and are taken on the inputs' device.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def get_stats(output: torch.Tensor, target: torch.Tensor, mode: str,
              ignore_index: Optional[int] = None, threshold: Optional[float] = None,
              num_classes: Optional[int] = None) -> Stats:
    """Per-image, per-class counts, each (N, C) long.

    binary / multilabel: ``output`` and ``target`` (N, C, ...); ``threshold``
    binarizes both. multiclass: (N, ...) integer class maps, ``num_classes``
    required, ``threshold`` refused; pixels whose target is ``ignore_index``
    count nowhere."""
    if target.is_floating_point():
        raise ValueError(f"Target should be one of the integer types, got {target.dtype}.")
    if output.is_floating_point() and threshold is None:
        raise ValueError(
            f"Output should be one of the integer types if ``threshold`` is not None, "
            f"got {output.dtype}.")
    if output.is_floating_point() and mode == "multiclass":
        raise ValueError(
            f"For ``multiclass`` mode ``output`` should be one of the integer types, "
            f"got {output.dtype}.")
    if mode not in {"binary", "multiclass", "multilabel"}:
        raise ValueError(
            f"``mode`` should be in ['binary', 'multiclass', 'multilabel'], got mode={mode}.")
    if mode == "multiclass" and threshold is not None:
        raise ValueError("``threshold`` parameter does not supported for this 'multiclass' mode")
    if output.shape != target.shape:
        raise ValueError(
            "Dimensions should match, but ``output`` shape is not equal to ``target`` "
            f"shape, {tuple(output.shape)} != {tuple(target.shape)}")
    if mode != "multiclass" and ignore_index is not None:
        raise ValueError(f"``ignore_index`` parameter is not supproted for '{mode}' mode")
    if mode == "multiclass":
        if num_classes is None:
            raise ValueError("``num_classes`` attribute should be not ``None`` for 'multiclass' mode.")
        if ignore_index is not None and 0 <= ignore_index <= num_classes - 1:
            raise ValueError(
                f"``ignore_index`` should be outside the class values range, but got class "
                f"values in range 0..{num_classes - 1} and ``ignore_index={ignore_index}``")
        return _get_stats_multiclass(output, target, num_classes, ignore_index)
    if threshold is not None:  # both sides: 0/255 masks rely on it
        output, target = output >= threshold, target >= threshold
    return _get_stats_multilabel(output, target)


def _get_stats_multiclass(output, target, num_classes: int, ignore_index) -> Stats:
    """Counts by ``bincount`` over image-offset classes; an ignored pixel goes
    to a bin past the classes on both sides, so it meets no class."""
    n = output.shape[0]
    out = output.reshape(n, -1).long()
    tgt = target.reshape(n, -1).long()
    bins = num_classes + 1
    if ignore_index is not None:
        valid = tgt != ignore_index
        tgt = torch.where(valid, tgt, num_classes)
        out = torch.where(valid, out, num_classes)
        n_valid = valid.sum(dim=1)
    else:
        n_valid = torch.full((n,), out.shape[1], dtype=torch.long, device=out.device)
    # a class outside [0, num_classes) counts as no class, as one_hot gives
    out, tgt = (torch.where((x >= 0) & (x < num_classes), x, num_classes) for x in (out, tgt))
    offset = (torch.arange(n, device=out.device) * bins)[:, None]

    def count(classes):
        return torch.bincount((classes + offset).reshape(-1), minlength=n * bins
                              ).reshape(n, bins)[:, :num_classes]

    tp = count(torch.where(out == tgt, tgt, num_classes))
    fp = count(out) - tp
    fn = count(tgt) - tp
    tn = n_valid[:, None] - tp - fp - fn
    return tp, fp, fn, tn


def _get_stats_multilabel(output, target) -> Stats:
    n, c = output.shape[0], output.shape[1]
    out = output.reshape(n, c, -1).long()
    tgt = target.reshape(n, c, -1).long()
    tp = (out * tgt).sum(2)
    fp = out.sum(2) - tp
    fn = tgt.sum(2) - tp
    tn = out.shape[2] - (tp + fp + fn)
    return tp, fp, fn, tn


def _handle_zero_division(x: torch.Tensor, zero_division) -> torch.Tensor:
    nans = torch.isnan(x)
    if zero_division == "warn" and bool(nans.any()):
        warnings.warn("Zero division in metric calculation!")
    value = 0.0 if zero_division == "warn" else float(zero_division)
    return torch.where(nans, torch.full_like(x, value), x)


def _compute_metric(metric_fn, tp, fp, fn, tn, reduction: Optional[str] = None,
                    class_weights=None, zero_division="warn", **kwargs) -> torch.Tensor:
    """smp's reductions (stcd_tpu/metrics/functional.py:114-145): explicit
    class_weights scale macro too; 'weighted*' without weights raises; micro
    gets no zero-division replacement (NaN propagates)."""
    tp, fp, fn, tn = (x.float() for x in (tp, fp, fn, tn))
    if class_weights is None and reduction is not None and "weighted" in reduction:
        raise ValueError(f"Class weights should be provided for `{reduction}` reduction")
    class_weights = (torch.as_tensor(class_weights, dtype=torch.float32, device=tp.device)
                     if class_weights is not None else torch.tensor(1.0, device=tp.device))
    class_weights = class_weights / class_weights.sum()

    if reduction == "micro":
        return metric_fn(tp.sum(), fp.sum(), fn.sum(), tn.sum(), **kwargs)
    if reduction in ("macro", "weighted"):
        score = metric_fn(tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0), **kwargs)
        score = _handle_zero_division(score, zero_division) * class_weights
        return score.sum() if reduction == "weighted" else score.mean()
    if reduction == "micro-imagewise":
        score = metric_fn(tp.sum(1), fp.sum(1), fn.sum(1), tn.sum(1), **kwargs)
        return _handle_zero_division(score, zero_division).mean()
    if reduction in ("macro-imagewise", "weighted-imagewise"):
        score = _handle_zero_division(metric_fn(tp, fp, fn, tn, **kwargs), zero_division)
        return (score.mean(0) * class_weights).mean()
    if reduction is None or reduction == "none":
        return _handle_zero_division(metric_fn(tp, fp, fn, tn, **kwargs), zero_division)
    raise ValueError(f"unknown reduction {reduction}")


def _fbeta(tp, fp, fn, tn, beta=1.0):
    b2 = beta ** 2
    return ((1 + b2) * tp) / ((1 + b2) * tp + b2 * fn + fp)


def _iou(tp, fp, fn, tn):
    return tp / (tp + fp + fn)


def _accuracy(tp, fp, fn, tn):
    return (tp + tn) / (tp + fp + fn + tn)


def _sensitivity(tp, fp, fn, tn):
    return tp / (tp + fn)


def _specificity(tp, fp, fn, tn):
    return tn / (tn + fp)


def _balanced_accuracy(tp, fp, fn, tn):
    return (_sensitivity(tp, fp, fn, tn) + _specificity(tp, fp, fn, tn)) / 2


def _ppv(tp, fp, fn, tn):
    return tp / (tp + fp)


def _npv(tp, fp, fn, tn):
    return tn / (tn + fn)


def _fnr(tp, fp, fn, tn):
    return fn / (fn + tp)


def _fpr(tp, fp, fn, tn):
    return fp / (fp + tn)


def _make(metric_fn):
    def metric(tp, fp, fn, tn, reduction=None, class_weights=None, zero_division="warn",
               **kwargs):
        return _compute_metric(metric_fn, tp, fp, fn, tn, reduction=reduction,
                               class_weights=class_weights, zero_division=zero_division,
                               **kwargs)
    return metric


fbeta_score = _make(_fbeta)
f1_score = _make(lambda tp, fp, fn, tn: _fbeta(tp, fp, fn, tn, beta=1.0))
iou_score = _make(_iou)
accuracy = _make(_accuracy)
sensitivity = _make(_sensitivity)
recall = sensitivity
specificity = _make(_specificity)
balanced_accuracy = _make(_balanced_accuracy)
positive_predictive_value = _make(_ppv)
precision = positive_predictive_value
negative_predictive_value = _make(_npv)
false_negative_rate = _make(_fnr)
false_positive_rate = _make(_fpr)
false_discovery_rate = _make(lambda tp, fp, fn, tn: 1.0 - _ppv(tp, fp, fn, tn))
false_omission_rate = _make(lambda tp, fp, fn, tn: 1.0 - _npv(tp, fp, fn, tn))
positive_likelihood_ratio = _make(lambda tp, fp, fn, tn:
                                  _sensitivity(tp, fp, fn, tn) / _fpr(tp, fp, fn, tn))
negative_likelihood_ratio = _make(lambda tp, fp, fn, tn:
                                  _fnr(tp, fp, fn, tn) / _specificity(tp, fp, fn, tn))
