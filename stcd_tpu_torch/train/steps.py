"""The train and eval steps (counterpart of stcd_tpu/train/steps.py;
stage 2, ``make_cd_steps``, is ported).

A batch holds ``A`` and ``B``, (N, H, W, 3) NHWC uint8 or float in [0, 1],
and ``label`` (N, H, W, 1), all on the state's device. Augmentation and
ImageNet normalisation run inside the step on that device; on a card the
augmentation is the CUDA kernel of ``ops/augment.py``, whose NHWC output is
a channels_last NCHW tensor for the model without a copy. The confusion
counts are taken on the device and returned with the loss as tensors: a
step forces no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from stcd_tpu_torch.data.augment import eval_preprocess, train_augment_pair
from stcd_tpu_torch.losses.functional import bce_dice
from stcd_tpu_torch.metrics.confusion import confusion_matrix


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _label_nchw(label: torch.Tensor) -> torch.Tensor:
    if label.dim() == 3:
        label = label[..., None]
    return _nchw(label)


def make_cd_steps(model=None, augment: bool = True, remat: bool = False,
                  accum_steps: int = 1):
    """Pseudo-change CD pretraining (stage 2). Returns
    ``(train_step, eval_step)``; ``model`` is taken for the JAX function's
    signature and is not used: the steps run the state's module.

    ``train_step(state, batch, generator=None, aug_params=None,
    augment_impl=None) -> {"loss", "cm"}`` updates ``state`` in place:
    augment the 2N images in one call (one jitter coin per pair), forward in
    train mode, loss = BCE + Dice on sigmoid(change logit), backward, one
    Adam update at the schedule's rate. ``aug_params`` (the pair of draw
    dicts for A and B) replaces the sampling from ``generator``.

    ``accum_steps > 1`` runs that many micro-batches in order: gradients
    averaged, BatchNorm running statistics updated per micro-batch, the
    loss averaged and the counts summed. ``remat=True`` recomputes the
    model's forward in the backward (``torch.utils.checkpoint``); the
    recomputation leaves the BatchNorm buffers as the first forward set them.

    ``eval_step(state, batch) -> {"cm", "probs"}``: eval mode, no grad,
    probabilities as (N, H, W, 1)."""

    def forward(state, a, b):
        with state.autocast():
            return state.model(a, b)[2]

    def train_step(state, batch, generator: Optional[torch.Generator] = None,
                   aug_params=None, augment_impl: Optional[str] = None):
        model = state.model.train()
        if augment:
            a, b = train_augment_pair(generator, batch["A"], batch["B"], jitter_p=0.5,
                                      aug_params=aug_params, impl=augment_impl)
        else:
            a, b = eval_preprocess(batch["A"]), eval_preprocess(batch["B"])
        a, b, label = _nchw(a), _nchw(b), _label_nchw(batch["label"]).float()
        n = a.shape[0]
        if n % accum_steps != 0:
            raise ValueError(f"batch {n} not divisible by accum_steps {accum_steps}")
        m = n // accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, cm = 0.0, 0
        for i in range(accum_steps):
            ma, mb, ml = (t[i * m:(i + 1) * m] for t in (a, b, label))
            if remat:
                diff = checkpoint(forward, state, ma, mb, use_reentrant=False)
                buffers = [buf.clone() for buf in model.buffers()]
            else:
                diff = forward(state, ma, mb)
            probs = torch.sigmoid(diff.float())
            loss = bce_dice(probs, ml)
            (loss / accum_steps).backward()
            if remat:  # the recomputed forward updated the running stats again
                with torch.no_grad():
                    for buf, saved in zip(model.buffers(), buffers):
                        buf.copy_(saved)
            loss_sum = loss_sum + loss.detach()
            cm = cm + confusion_matrix(probs.detach() > 0.5, ml)
        state.apply_gradients()
        return {"loss": loss_sum / accum_steps, "cm": cm}

    @torch.no_grad()
    def eval_step(state, batch):
        state.model.eval()
        a, b = _nchw(eval_preprocess(batch["A"])), _nchw(eval_preprocess(batch["B"]))
        probs = torch.sigmoid(forward(state, a, b).float())
        cm = confusion_matrix(probs > 0.5, _label_nchw(batch["label"]))
        return {"cm": cm, "probs": probs.permute(0, 2, 3, 1)}

    return train_step, eval_step
