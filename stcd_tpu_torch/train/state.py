"""Train state of the port (counterpart of stcd_tpu/train/state.py): the
module (parameters and BatchNorm buffers), Adam, the schedule and the count
of updates made. The state is mutable; a train step updates it in place."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from stcd_tpu_torch.cli.predict import resolve_device
from stcd_tpu_torch.train.schedules import Schedule, poly_schedule


class AdamConfig(NamedTuple):
    """What optax.adam(schedule, b1, b2) holds in the JAX package."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


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

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def autocast(self):
        """bfloat16 autocast around the model's forward when the state was
        created with ``bf16=True``; the parameters stay float32."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16)

    def apply_gradients(self) -> None:
        """One Adam update at the schedule's rate for this step. The rate
        is the schedule at the count before the update, as optax takes it."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, tx: AdamConfig, device="cuda", bf16: bool = False,
                       encoder_weights: Optional[str] = None) -> TrainState:
    """Move ``model`` to ``device`` and wrap it with Adam into a TrainState.

    ``device`` is ``"cuda"`` unless the caller asks for the CPU; ``cuda``
    without a card raises. On a card the model is laid out channels_last.
    ``bf16`` runs the forward under bfloat16 autocast with float32 master
    weights. ``encoder_weights`` is the path of a torch state_dict under
    torchvision's names, loaded strictly into ``model.encoder``; resolving
    ``"imagenet"`` against a directory of converted weights is not ported."""
    device = resolve_device(device)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    if encoder_weights is not None:
        if encoder_weights == "imagenet":
            raise NotImplementedError(
                "encoder_weights='imagenet' is not ported: pass the path of a torch "
                "state_dict (ROADMAP.md Queue 1 #6)")
        sd = torch.load(encoder_weights, map_location=device, weights_only=True)
        model.encoder.load_state_dict(sd, strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=tx.schedule(0),
                                 betas=(tx.b1, tx.b2), eps=tx.eps)
    return TrainState(model=model, optimizer=optimizer, schedule=tx.schedule, bf16=bf16)
