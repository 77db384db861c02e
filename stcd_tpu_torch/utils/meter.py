"""smp's utils (counterpart of stcd_tpu/utils/meter.py): the running meter,
the metric objects (IoU, Fscore, Accuracy, Precision, Recall), the loss
objects that compose with ``+`` and ``*``, and the fit loop
``Epoch`` / ``TrainEpoch`` / ``ValidEpoch`` over ``train.state.TrainState``.

NCHW, as smp has it: ``ignore_channels`` drops channels of dim 1, and
``CrossEntropyLoss`` / ``NLLLoss`` take (N, C, H, W) scores and an
(N, H, W) integer target.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from stcd_tpu_torch.layers.modules import Activation
from stcd_tpu_torch.layers.stochastic import set_generator
from stcd_tpu_torch.train.state import (AdamConfig, AdamWConfig, OptimizerConfig, SGDConfig,
                                        make_optimizer)


class AverageValueMeter:
    """smp's AverageValueMeter, with its quirks: ``sum`` adds the raw value
    (not value * n), and at n == 1 the mean is the sum."""

    def __init__(self):
        self.reset()

    def add(self, value, n=1):
        self.val = value
        self.sum += value
        self.var += value * value
        self.n += n
        if self.n == 0:
            self.mean, self.std = np.nan, np.nan
        elif self.n == 1:
            self.mean = 0.0 + self.sum
            self.std = np.inf
            self.mean_old = self.mean
            self.m_s = 0.0
        else:
            self.mean = self.mean_old + (value - n * self.mean_old) / float(self.n)
            self.m_s += (value - self.mean_old) * (value - self.mean)
            self.mean_old = self.mean
            self.std = math.sqrt(self.m_s / (self.n - 1.0))

    def value(self):
        return self.mean, self.std

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.var = 0.0
        self.val = 0.0
        self.mean = np.nan
        self.mean_old = 0.0
        self.m_s = 0.0
        self.std = np.nan


def _threshold(x, threshold=None):
    return (x > threshold).float() if threshold is not None else x


def _take_channels(ignore_channels, *xs):
    """Drop the channels of dim 1 named in ``ignore_channels``."""
    if ignore_channels is None:
        return xs
    keep = [c for c in range(xs[0].shape[1]) if c not in ignore_channels]
    # slices, not an index tensor: building one on a card would copy from the host
    return tuple(torch.cat([x[:, c:c + 1] for c in keep], dim=1) for x in xs)


def _prepare(pr, gt, activation, threshold, ignore_channels):
    """smp's metrics take the model's output as it is (activation None) unless
    told otherwise: a model built with activation='sigmoid' already emits
    probabilities."""
    pr = _threshold(Activation(activation)(pr), threshold)
    return _take_channels(ignore_channels, pr, gt)


@dataclasses.dataclass
class IoU:
    eps: float = 1e-7
    threshold: float = 0.5
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "iou_score"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, self.threshold, self.ignore_channels)
        inter = (gt * pr).sum()
        union = gt.sum() + pr.sum() - inter + self.eps
        return (inter + self.eps) / union


@dataclasses.dataclass
class Fscore:
    eps: float = 1e-7
    beta: float = 1.0
    threshold: float = 0.5
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "fscore"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, self.threshold, self.ignore_channels)
        tp = (gt * pr).sum()
        fp = pr.sum() - tp
        fn = gt.sum() - tp
        b2 = self.beta ** 2
        return ((1 + b2) * tp + self.eps) / ((1 + b2) * tp + b2 * fn + fp + self.eps)


@dataclasses.dataclass
class Accuracy:
    threshold: float = 0.5
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "accuracy"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, self.threshold, self.ignore_channels)
        return (pr == gt).float().mean()


@dataclasses.dataclass
class Precision:
    eps: float = 1e-7
    threshold: float = 0.5
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "precision"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, self.threshold, self.ignore_channels)
        tp = (gt * pr).sum()
        fp = pr.sum() - tp
        return (tp + self.eps) / (tp + fp + self.eps)


@dataclasses.dataclass
class Recall:
    eps: float = 1e-7
    threshold: float = 0.5
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "recall"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, self.threshold, self.ignore_channels)
        tp = (gt * pr).sum()
        fn = gt.sum() - tp
        return (tp + self.eps) / (tp + fn + self.eps)


class Loss:
    """Loss objects compose with ``+`` (SumOfLosses) and ``*`` by a number
    (MultipliedLoss), and the composite's ``__name__`` says how."""

    def __add__(self, other):
        if isinstance(other, Loss):
            return SumOfLosses(self, other)
        raise ValueError("Loss should be inherited from `Loss` class")

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, value):
        if isinstance(value, (int, float)):
            return MultipliedLoss(self, value)
        raise ValueError("Loss should be inherited from `BaseLoss` class")

    def __rmul__(self, other):
        return self.__mul__(other)


class SumOfLosses(Loss):
    def __init__(self, l1, l2):
        self.l1, self.l2 = l1, l2
        self.__name__ = f"{l1.__name__} + {l2.__name__}"

    def __call__(self, *inputs):
        return self.l1(*inputs) + self.l2(*inputs)


class MultipliedLoss(Loss):
    def __init__(self, loss, multiplier):
        self.loss, self.multiplier = loss, multiplier
        if "+" in loss.__name__:
            self.__name__ = f"{multiplier} * ({loss.__name__})"
        else:
            self.__name__ = f"{multiplier} * {loss.__name__}"

    def __call__(self, *inputs):
        return self.multiplier * self.loss(*inputs)


@dataclasses.dataclass
class JaccardLoss(Loss):
    """1 - soft Jaccard, eps = 1."""

    eps: float = 1.0
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "jaccard_loss"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, None, self.ignore_channels)
        inter = (gt * pr).sum()
        union = gt.sum() + pr.sum() - inter + self.eps
        return 1.0 - (inter + self.eps) / union


@dataclasses.dataclass
class DiceLoss(Loss):
    """1 - soft F-score, eps = 1."""

    eps: float = 1.0
    beta: float = 1.0
    activation: object = None
    ignore_channels: object = None

    def __post_init__(self):
        self.__name__ = "dice_loss"

    def __call__(self, pr, gt):
        pr, gt = _prepare(pr, gt, self.activation, None, self.ignore_channels)
        tp = (gt * pr).sum()
        fp = pr.sum() - tp
        fn = gt.sum() - tp
        b2 = self.beta ** 2
        return 1.0 - ((1 + b2) * tp + self.eps) / ((1 + b2) * tp + b2 * fn + fp + self.eps)


class L1Loss(Loss):
    __name__ = "l1_loss"

    def __call__(self, pr, gt):
        return F.l1_loss(pr, gt)


class MSELoss(Loss):
    __name__ = "mse_loss"

    def __call__(self, pr, gt):
        return F.mse_loss(pr, gt)


class CrossEntropyLoss(Loss):
    """Softmax cross-entropy of (N, C, ...) logits and an integer target."""

    __name__ = "cross_entropy_loss"

    def __call__(self, pr, gt):
        return F.cross_entropy(pr, gt.long())


class NLLLoss(Loss):
    """Mean -log_prob[target] of (N, C, ...) log-probabilities."""

    __name__ = "nll_loss"

    def __call__(self, pr, gt):
        return F.nll_loss(pr, gt.long())


class BCELoss(Loss):
    """Binary cross-entropy of probabilities, the logs clamped at -100."""

    __name__ = "bce_loss"

    def __call__(self, pr, gt):
        return F.binary_cross_entropy(pr, gt)


class BCEWithLogitsLoss(Loss):
    __name__ = "bce_with_logits_loss"

    def __call__(self, pr, gt):
        return F.binary_cross_entropy_with_logits(pr, gt)


def _to_device_nchw(x, device) -> torch.Tensor:
    """An NHWC batch (numpy or tensor) on ``device`` as a channels_last NCHW
    view; integers and float64 become float32, as jnp.asarray makes them
    without 64-bit mode. An (N, H, W) label gets its channel."""
    x = torch.as_tensor(x).to(device, non_blocking=True)
    if not x.is_floating_point() or x.dtype == torch.float64:
        x = x.float()
    if x.dim() == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)


class Epoch:
    """One pass over a loader of dict batches: ``{"image", "label"}``, or
    ``{"A", "B", "label"}`` (the model gets both images), or ``{"A",
    "label"}``, NHWC. ``run(state, loader) -> (state, logs)`` with the mean
    loss and the mean of each metric under its ``__name__``.

    ``model`` stands where the JAX runner takes ``apply_fn`` and is not used:
    the state's module runs. A batch goes to ``state.device`` once; the only
    host reads a batch are the loss's and each metric's ``float``."""

    def __init__(self, model, loss, metrics: List, stage_name: str, verbose: bool = True):
        self.model = model
        self.loss = loss
        self.metrics = metrics
        self.stage_name = stage_name
        self.verbose = verbose

    def batch_update(self, state, xs, y):
        raise NotImplementedError

    def run(self, state, dataloader):
        loss_meter = AverageValueMeter()
        metric_meters = {m.__name__: AverageValueMeter() for m in self.metrics}
        for batch in dataloader:
            keys = ("image",) if "image" in batch else ("A", "B") if "B" in batch else ("A",)
            xs = tuple(_to_device_nchw(batch[k], state.device) for k in keys)
            y = _to_device_nchw(batch["label"], state.device)
            state, loss, pred = self.batch_update(state, xs, y)
            loss_meter.add(float(loss))
            for m in self.metrics:
                metric_meters[m.__name__].add(float(m(pred, y)))
        logs = {"loss": loss_meter.mean}
        logs.update({k: v.mean for k, v in metric_meters.items()})
        return state, logs


class ValidEpoch(Epoch):
    """The model in eval mode, without autograd."""

    def __init__(self, model, loss, metrics, verbose=True):
        super().__init__(model, loss, metrics, "valid", verbose)

    @torch.no_grad()
    def batch_update(self, state, xs, y):
        state.model.eval()
        with state.autocast():
            pred = state.model(*xs)
        return state, self.loss(pred, y), pred


_OPTIMIZERS = {AdamConfig: torch.optim.Adam, SGDConfig: torch.optim.SGD,
               AdamWConfig: torch.optim.AdamW}


class _CountFrom:
    """A schedule read from update ``start`` on: an optimizer made anew at
    update ``start`` counts its schedule from 0, as a fresh optax state does."""

    def __init__(self, schedule, start: int):
        self.schedule, self.start = schedule, start

    def __call__(self, step):
        return self.schedule(step - self.start)


def swap_optimizer(state, tx: OptimizerConfig):
    """Give ``state`` the optimizer of ``tx`` between epochs, by the JAX
    runner's rule. A config of the optimizer's own kind keeps its moments
    (Adam's, AdamW's, SGD's momentum) and the count its schedule reads, with
    the new schedule and hyperparameters; another kind starts a new optimizer
    whose schedule counts from 0. ``state.step`` is kept either way."""
    start = getattr(state.schedule, "start", 0)
    if type(state.optimizer) is _OPTIMIZERS[type(tx)]:
        fresh = make_optimizer(tx, [torch.zeros(())]).defaults
        for group in state.optimizer.param_groups:
            group.update({k: v for k, v in fresh.items() if k != "lr"})
    else:
        state.optimizer = make_optimizer(tx, state.model.parameters())
        start = state.step
    state.schedule = _CountFrom(tx.schedule, start) if start else tx.schedule
    return state


class TrainEpoch(Epoch):
    """The model in train mode, its dropouts drawing from the state's
    generator; one optimizer update a batch. ``tx`` (an optimizer config)
    replaces the state's optimizer at the start of ``run``
    (``swap_optimizer``), as smp's notebooks lower the rate between epochs."""

    def __init__(self, model, loss, metrics, tx=None, verbose=True):
        super().__init__(model, loss, metrics, "train", verbose)
        self.tx = tx

    def run(self, state, dataloader):
        if self.tx is not None:
            state = swap_optimizer(state, self.tx)
        return super().run(state, dataloader)

    def batch_update(self, state, xs, y):
        model = set_generator(state.model.train(), state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        with state.autocast():
            pred = model(*xs)
        loss = self.loss(pred, y)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach(), pred.detach()
