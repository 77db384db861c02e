"""Config-driven CDTrainer: the train and eval steps (counterpart of
stcd_tpu/train/trainer.py, ``CDTrainer._build_steps`` and what it calls).

Ported: ``TrainerConfig``, the optimizer choice sgd / adam / adamw, the loss
dispatch ce / bce / cd_loss / fl / miou / mmiou with multi-scale training, multi-scale inference,
and ``train_step`` / ``eval_step`` with on-device normalisation, augmentation,
bf16 autocast and confusion counts. Not ported yet: the trainer's epoch loop
(``train_models``, ``_run_epoch``) and ``CDEvaluator``, which would write
through the ported ``train/checkpoint.py`` and ``utils/logging.py`` (ROADMAP.md
Queue 1 #7), and pipeline and tensor parallelism (Queue 1 #11).

The steps take ``a`` and ``b`` as (N, H, W, 3) NHWC images, uint8 or float in
[0, 1], and ``label`` as (N, H, W, 1), all on the state's device, as the JAX
steps do; the models run NCHW inside. The state is mutable: ``train_step``
updates it in place and returns ``(loss, confusion counts)`` as tensors on
the device, so a step forces no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from stcd_tpu_torch.data.augment import eval_preprocess, to_float01, train_augment_pair
from stcd_tpu_torch.layers.modules import upsample_nearest
from stcd_tpu_torch.layers.stochastic import set_generator
from stcd_tpu_torch.losses import functional as L
from stcd_tpu_torch.metrics.confusion import confusion_matrix
from stcd_tpu_torch.models.factory import define_G, init_weights
from stcd_tpu_torch.train.schedules import Schedule, get_scheduler
from stcd_tpu_torch.train.state import (AdamConfig, AdamWConfig, OptimizerConfig, SGDConfig,
                                        TrainState, create_train_state)


@dataclasses.dataclass
class TrainerConfig:
    """The args object of the reference trainer, as the JAX package keeps it,
    without the pipeline- and tensor-parallel fields and without
    ``checkpoint_dir`` and ``vis_dir``, whose readers (checkpoints, logging)
    are not ported. ``dtype`` is None or
    ``torch.float32`` for float32, ``torch.bfloat16`` for bf16 autocast with
    float32 weights."""

    net_G: str = "base_transformer_pos_s4_dd8"
    n_class: int = 2
    embed_dim: int = 64
    img_size: int = 256
    lr: float = 0.01
    optimizer: str = "sgd"
    lr_policy: str = "linear"
    lr_decay_iters: int = 50
    max_epochs: int = 100
    loss: str = "ce"
    multi_scale_train: bool = False
    multi_scale_infer: bool = False
    multi_pred_weights: Sequence[float] = (0.5, 0.5, 0.5, 0.8, 1.0)
    batch_size: int = 8
    seed: int = 1337
    dtype: Any = None
    # ``normalize`` applies ImageNet mean/std inside the step; ``augment``
    # applies the train-time photometric pipeline (one jitter coin per pair)
    # to training batches and always ends in normalisation.
    normalize: bool = True
    augment: bool = False


def _make_optimizer(cfg: TrainerConfig, schedule: Schedule) -> OptimizerConfig:
    if cfg.optimizer == "sgd":
        return SGDConfig(schedule, momentum=0.99, weight_decay=5e-4)
    if cfg.optimizer == "adam":
        return AdamConfig(schedule)
    if cfg.optimizer == "adamw":
        return AdamWConfig(schedule, b1=0.9, b2=0.999, weight_decay=0.01)
    raise NotImplementedError(cfg.optimizer)


def _as_list(pred) -> List[torch.Tensor]:
    return list(pred) if isinstance(pred, (list, tuple)) else [pred]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class CDTrainer:
    """The args-driven training harness over the ``define_G`` zoo: it builds
    the model, the schedule and the optimizer config from ``cfg`` and offers
    ``init_state``, ``train_step`` and ``eval_step``. ``steps_per_epoch``
    stands for the length of the train loader (the schedules are per epoch);
    ``alpha`` for the class counts the JAX trainer scans its train loader for."""

    def __init__(self, cfg: TrainerConfig, steps_per_epoch: int = 1, alpha=None):
        self.cfg = cfg
        self.alpha = alpha  # class counts (``get_alpha``) for the losses fl and miou
        self.model = define_G(cfg.net_G, n_class=cfg.n_class, embed_dim=cfg.embed_dim)
        schedule = get_scheduler(cfg.lr_policy, cfg.lr, max(steps_per_epoch, 1),
                                 max_epochs=cfg.max_epochs,
                                 lr_decay_iters=cfg.lr_decay_iters)
        self.tx = _make_optimizer(cfg, schedule)

    def init_state(self, device="cuda", init_seed: Optional[int] = None) -> TrainState:
        """The model on ``device`` with its optimizer and a generator seeded
        with ``cfg.seed`` for the steps' draws. ``init_seed`` gives seeded
        random weights (``models.factory.init_weights``); None keeps the
        weights the modules were built with."""
        if init_seed is not None:
            init_weights(self.model, init_seed)
        return create_train_state(self.model, self.tx, device=device,
                                  bf16=self.cfg.dtype == torch.bfloat16,
                                  seed=self.cfg.seed)

    # --- loss dispatch ---
    def _pxl_loss(self, preds: List[torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
        """``preds``: NCHW logits, the full-resolution one last; ``gt``:
        (N, 1, H, W). With ``multi_scale_train`` every scale is weighed by
        ``multi_pred_weights`` against a nearest-downsampled label."""
        cfg = self.cfg
        sel = preds if cfg.multi_scale_train else preds[-1:]
        weights = list(cfg.multi_pred_weights)[:len(sel)] if cfg.multi_scale_train else [1.0]
        losses = []
        for w, pred in zip(weights, sel):
            g = gt
            if pred.shape[2] != gt.shape[2]:
                factor = gt.shape[2] // pred.shape[2]
                g = gt[:, :, ::factor, ::factor]  # nearest downsample
            if cfg.loss == "ce":
                losses.append(w * L.cross_entropy(pred, g[:, 0]))
            elif cfg.loss in ("bce", "cd_loss"):
                if pred.shape[1] != g.shape[1]:
                    raise ValueError(
                        f"loss={cfg.loss!r} needs prediction channels == label channels "
                        f"(got {pred.shape[1]} vs {g.shape[1]}); use n_class=1 or "
                        "loss='ce'")
                fn = L.bce_loss if cfg.loss == "bce" else L.cd_loss
                losses.append(w * fn(torch.sigmoid(pred.float()), g))
            elif cfg.loss == "fl":
                losses.append(w * L.focal_loss(pred, g[:, 0], alpha=self.alpha, gamma=2.0,
                                               smooth=1e-5))
            elif cfg.loss == "miou":
                if self.alpha is None:
                    raise ValueError("loss='miou' weighs the classes by their frequency: "
                                     "pass alpha=losses.functional.get_alpha(train_loader) "
                                     "to CDTrainer")
                a = np.asarray(self.alpha, np.float64)
                losses.append(w * L.miou_loss(pred, g[:, 0], weight=1.0 - a / a.sum(),
                                              n_classes=cfg.n_class))
            elif cfg.loss == "mmiou":
                losses.append(w * L.mmiou_loss(pred, g[:, 0], n_classes=cfg.n_class))
            else:
                raise NotImplementedError(cfg.loss)
        return sum(losses)

    def _final_pred(self, preds: List[torch.Tensor]) -> torch.Tensor:
        """multi_scale_infer: the mean of all scales at full resolution."""
        if not self.cfg.multi_scale_infer or len(preds) == 1:
            return preds[-1]
        full = preds[-1]
        acc = torch.zeros_like(full)
        for p in preds:
            if p.shape[2] != full.shape[2]:
                p = upsample_nearest(p, full.shape[2] // p.shape[2])
            acc = acc + p
        return acc / len(preds)

    def _pred_to_labels(self, pred: torch.Tensor) -> torch.Tensor:
        if self.cfg.n_class > 1:
            return torch.argmax(pred, dim=1)
        # the models emit logits: probability 0.5 is logit 0
        return (torch.sigmoid(pred.float()) >= 0.5).to(torch.int64)[:, 0]

    def _counts(self, preds: List[torch.Tensor], label: torch.Tensor):
        """(final prediction, confusion counts on the device)."""
        final = self._final_pred(preds)
        return final, confusion_matrix(self._pred_to_labels(final), label[:, 0],
                                       self.cfg.n_class)

    # --- the steps ---
    def train_step(self, state: TrainState, a: torch.Tensor, b: torch.Tensor,
                   label: torch.Tensor):
        """One update of ``state`` in place; returns ``(loss, cm)``. The
        augmentation's draws, every dropout and DropPath mask and the attention
        seeds come from the state's generator, which ``init_state`` seeds."""
        cfg = self.cfg
        gen = state.generator
        model = set_generator(state.model.train(), gen)
        if cfg.augment:
            if gen is None:
                raise ValueError("augment=True needs a state with a generator: build "
                                 "it with CDTrainer.init_state")
            a, b = train_augment_pair(gen, a, b)
        elif cfg.normalize:
            a, b = eval_preprocess(a), eval_preprocess(b)
        else:
            a, b = to_float01(a), to_float01(b)
        a, b, label = _nchw(a), _nchw(b), _nchw(label)
        state.optimizer.zero_grad(set_to_none=True)
        with state.autocast():
            preds = _as_list(model(a, b))
        loss = self._pxl_loss(preds, label)
        loss.backward()
        state.apply_gradients()
        _, cm = self._counts([p.detach() for p in preds], label)
        return loss.detach(), cm

    @torch.no_grad()
    def eval_step(self, state: TrainState, a: torch.Tensor, b: torch.Tensor,
                  label: torch.Tensor):
        """Eval mode, no grad; returns ``(final NCHW prediction, cm)``."""
        cfg = self.cfg
        model = state.model.eval()
        if cfg.normalize or cfg.augment:
            a, b = eval_preprocess(a), eval_preprocess(b)
        else:
            a, b = to_float01(a), to_float01(b)
        with state.autocast():
            preds = _as_list(model(_nchw(a), _nchw(b)))
        return self._counts(preds, _nchw(label))
