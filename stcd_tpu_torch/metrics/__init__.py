"""Metrics of the port (counterpart of stcd_tpu/metrics): the confusion
counts of the reference's scripts and smp's functional metrics."""

from stcd_tpu_torch.metrics.confusion import SegmentationMetric, confusion_matrix  # noqa: F401
from stcd_tpu_torch.metrics.functional import (  # noqa: F401
    accuracy, balanced_accuracy, f1_score, false_discovery_rate, false_negative_rate,
    false_omission_rate, false_positive_rate, fbeta_score, get_stats, iou_score,
    negative_likelihood_ratio, negative_predictive_value, positive_likelihood_ratio,
    positive_predictive_value, precision, recall, sensitivity, specificity)
