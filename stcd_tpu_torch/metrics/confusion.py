"""Confusion-matrix segmentation metrics (counterpart of
stcd_tpu/metrics/confusion.py). The per-batch count runs on the tensors'
device and forces no host sync; accumulation happens on the host in numpy
float64, as the reference keeps it. Under a process group of W > 1 ranks a
rank counts its own rows, and ``global_counts`` sums the counts over the
ranks: the train steps do so before their counts leave the step, the eval
loop once an evaluation, so that the metrics (and the best-by-IoU choice) are
those of the global batch, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from stcd_tpu_torch.parallel import distributed


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int = 2) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts; rows = label, cols = pred,
    i.e. ``bincount(num_classes * label + pred)`` reshaped. Values must lie
    in [0, num_classes)."""
    idx = num_classes * label.reshape(-1).to(torch.int64) + pred.reshape(-1).to(torch.int64)
    return torch.bincount(idx, minlength=num_classes ** 2)[:num_classes ** 2].reshape(
        num_classes, num_classes)


def global_counts(cm: torch.Tensor) -> torch.Tensor:
    """Counts summed over the ranks (every rank calls it together); ``cm``
    itself in one process."""
    return distributed.all_reduce_(cm.clone()) if distributed.data_parallel() else cm


class SegmentationMetric:
    """Host-side float64 accumulator; the method names are the reference's,
    and all return numpy values."""

    def __init__(self, num_classes: int = 2):
        self.numClass = num_classes
        self.reset()

    def reset(self):
        self.confusionMatrix = np.zeros((self.numClass, self.numClass), np.float64)

    def addBatch(self, pred, label):
        """pred/label: int arrays or tensors (any device), identical shapes."""
        cm = confusion_matrix(torch.as_tensor(pred), torch.as_tensor(label), self.numClass)
        self.confusionMatrix += cm.cpu().numpy().astype(np.float64)
        return self.confusionMatrix

    def getConfusionMatrix(self):
        return self.confusionMatrix

    def OverallAccuracy(self):
        return np.diag(self.confusionMatrix).sum() / self.confusionMatrix.sum()

    def Precision(self):
        return np.diag(self.confusionMatrix) / self.confusionMatrix.sum(0)

    def Recall(self):
        return np.diag(self.confusionMatrix) / self.confusionMatrix.sum(1)

    def F1score(self):
        p, r = self.Precision(), self.Recall()
        return 2 * p * r / (p + r)

    def IntersectionOverUnion(self):
        inter = np.diag(self.confusionMatrix)
        union = self.confusionMatrix.sum(1) + self.confusionMatrix.sum(0) - inter
        return inter / union

    def meanIntersectionOverUnion(self):
        return np.mean(self.IntersectionOverUnion())

    def Frequency_Weighted_Intersection_over_Union(self):
        freq = self.confusionMatrix.sum(1) / (self.confusionMatrix.sum() + 1e-8)
        inter = np.diag(self.confusionMatrix)
        iu = inter / (self.confusionMatrix.sum(1) + self.confusionMatrix.sum(0)
                      - inter + 1e-8)
        return (freq[freq > 0] * iu[freq > 0]).sum()
