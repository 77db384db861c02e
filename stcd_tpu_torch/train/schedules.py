"""Learning-rate schedules as plain functions of the global step
(counterpart of stcd_tpu/train/schedules.py). ``schedule(t)`` is the rate
of the update that follows ``t`` earlier updates: step 0 uses the base rate."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def poly_schedule(base_lr: float, num_epochs: int, iters_per_epoch: int,
                  power: float = 0.9, warmup_epochs: int = 0) -> Schedule:
    """base * (1 - t/N)^power per iteration, N = epochs * iters_per_epoch,
    with an optional linear warm-up over the first warmup_epochs."""
    total = num_epochs * iters_per_epoch
    warmup_iters = warmup_epochs * iters_per_epoch

    def schedule(step):
        if step < warmup_iters:
            return base_lr * step / warmup_iters
        return base_lr * max(1.0 - step / total, 0.0) ** power

    return schedule


def linear_decay_schedule(base_lr: float, max_epochs: int, iters_per_epoch: int) -> Schedule:
    """factor = 1 - epoch / (max_epochs + 1)."""
    return lambda step: base_lr * (1.0 - (step // iters_per_epoch) / float(max_epochs + 1))


def step_schedule(base_lr: float, lr_decay_iters: int, iters_per_epoch: int,
                  gamma: float = 0.5) -> Schedule:
    """StepLR(step_size=lr_decay_iters, gamma) per epoch."""
    return lambda step: base_lr * gamma ** math.floor(
        (step // iters_per_epoch) / lr_decay_iters)


def exponential_schedule(base_lr: float, iters_per_epoch: int, gamma: float = 0.95) -> Schedule:
    """ExponentialLR(gamma) per epoch."""
    return lambda step: base_lr * gamma ** (step // iters_per_epoch)


def get_scheduler(lr_policy, base_lr: float, iters_per_epoch: int, max_epochs: int = 100,
                  lr_decay_iters: int = 50) -> Schedule:
    """Factory keyed like the reference (linear, step, exponential, poly, None)."""
    if lr_policy == "linear":
        return linear_decay_schedule(base_lr, max_epochs, iters_per_epoch)
    if lr_policy == "step":
        return step_schedule(base_lr, lr_decay_iters, iters_per_epoch)
    if lr_policy == "exponential":
        return exponential_schedule(base_lr, iters_per_epoch)
    if lr_policy == "poly":
        return poly_schedule(base_lr, max_epochs, iters_per_epoch)
    if lr_policy is None:
        return lambda step: base_lr
    raise NotImplementedError(f"learning rate policy [{lr_policy}] is not implemented")
