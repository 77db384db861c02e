"""Train state of the port (counterpart of stcd_tpu/train/state.py): the
module (parameters and BatchNorm buffers), the optimizer (Adam, SGD or AdamW),
the schedule, the generator of the step's random draws and the count of
updates made. The state is mutable; a train step updates it in place."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from stcd_tpu_torch.cli.predict import resolve_device
from stcd_tpu_torch.convert.pretrained import resolve_encoder_weights
from stcd_tpu_torch.encoders import load_encoder_weights
from stcd_tpu_torch.train.schedules import Schedule, poly_schedule


class AdamConfig(NamedTuple):
    """What optax.adam(schedule, b1, b2) holds in the JAX package."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class SGDConfig(NamedTuple):
    """optax.chain(add_decayed_weights(wd), sgd(schedule, momentum)): the
    decay joins the gradient before the momentum trace and the rate scales
    the trace, which is ``torch.optim.SGD`` with dampening 0."""

    schedule: Schedule
    momentum: float = 0.99
    weight_decay: float = 5e-4


class AdamWConfig(NamedTuple):
    """optax.adamw(schedule, b1, b2, weight_decay): the update is
    -lr (adam + wd p). ``torch.optim.AdamW`` first scales p by 1 - lr wd and
    then subtracts lr adam: the same step, p taken before the update in both."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01


OptimizerConfig = Union[AdamConfig, SGDConfig, AdamWConfig]


def make_optimizer(tx: OptimizerConfig, params) -> torch.optim.Optimizer:
    """The torch optimizer that takes the steps of ``tx``'s optax chain."""
    lr = tx.schedule(0)
    if isinstance(tx, SGDConfig):
        return torch.optim.SGD(params, lr=lr, momentum=tx.momentum, dampening=0.0,
                               weight_decay=tx.weight_decay)
    if isinstance(tx, AdamWConfig):
        return torch.optim.AdamW(params, lr=lr, betas=(tx.b1, tx.b2), eps=tx.eps,
                                 weight_decay=tx.weight_decay)
    if isinstance(tx, AdamConfig):
        return torch.optim.Adam(params, lr=lr, betas=(tx.b1, tx.b2), eps=tx.eps)
    raise TypeError(f"not an optimizer config: {tx!r}")


def adam_poly(base_lr: float = 1e-3, num_epochs: int = 60, iters_per_epoch: int = 100,
              power: float = 0.9, b1: float = 0.9, b2: float = 0.999) -> AdamConfig:
    """The reference's optimizer: Adam(lr=1e-3, betas=(0.9, 0.999)) with a
    per-iteration Poly(0.9) decay."""
    return AdamConfig(poly_schedule(base_lr, num_epochs, iters_per_epoch, power), b1, b2)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    bf16: bool = False
    step: int = 0
    generator: Optional[torch.Generator] = None  # the step's draws; None: the global one

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def autocast(self):
        """bfloat16 autocast around the model's forward when the state was
        created with ``bf16=True``; the parameters stay float32."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16)

    def apply_gradients(self) -> None:
        """One optimizer update at the schedule's rate for this step. The rate
        is the schedule at the count before the update, as optax takes it."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, tx: OptimizerConfig, device="cuda",
                       bf16: bool = False, encoder_weights: Optional[str] = None,
                       seed: Optional[int] = None) -> TrainState:
    """Move ``model`` to ``device`` and wrap it with ``tx``'s optimizer into a
    TrainState. ``seed`` gives the state a generator of its own on that device
    for the step's random draws (dropout, DropPath, attention seeds,
    augmentation).

    ``device`` is ``"cuda"`` unless the caller asks for the CPU; ``cuda``
    without a card raises. On a card the model is laid out channels_last.
    ``bf16`` runs the forward under bfloat16 autocast with float32 master
    weights. ``encoder_weights`` is a torch state_dict under torchvision's
    names, loaded strictly into ``model.encoder``: its path, or ``"imagenet"``
    for ``{encoder}.pth`` under ``$STCD_PRETRAINED_DIR``
    (``convert.pretrained.resolve_encoder_weights``: a missing file raises,
    nothing is downloaded). A torchvision classifier (``fc.*``, VGG's
    ``classifier.*``) is dropped first (``encoders.load_encoder_weights``), as
    smp's encoders drop it and the JAX converters never read it; every other
    unexpected or missing key raises. A file without ``num_batches_tracked`` loads
    (``layers.norm.BatchNorm``)."""
    device = resolve_device(device)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    path = resolve_encoder_weights(encoder_weights, getattr(model, "encoder_name", None))
    if path is not None:
        load_encoder_weights(model.encoder, path)
    generator = None
    if seed is not None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=make_optimizer(tx, model.parameters()),
                      schedule=tx.schedule, bf16=bf16, generator=generator)
