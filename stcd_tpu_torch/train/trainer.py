"""Config-driven CDTrainer and CDEvaluator (counterpart of
stcd_tpu/train/trainer.py).

Ported: ``TrainerConfig``, the optimizer choice sgd / adam / adamw, the loss
dispatch ce / bce / cd_loss / fl / miou / mmiou with multi-scale training,
multi-scale inference, ``train_step`` / ``eval_step`` with on-device
normalisation, augmentation, bf16 autocast and confusion counts, and the epoch
loop: ``train_models`` (resume from ``last_ckpt``, ``best_ckpt`` by val mF1,
the ``train_acc.npy`` / ``val_acc.npy`` curves, the scalar log) and
``CDEvaluator`` (weights-only load of ``best_ckpt`` or ``last_ckpt``, the
scores, the masks). They write through ``train/checkpoint.py`` (one
``torch.save`` file where the JAX package writes an orbax directory of the
same name) and ``utils/logging.py``.

Over a process group (``torchrun --nproc_per_node W``) the trainer runs a
``data`` x ``model`` x ``stage`` grid, D = W / (``tp_axis`` x ``pp_stages``)
(``parallel/mesh.py``; JAX's stcd_tpu/train/trainer.py:204-214): each
step takes this rank's rows of the global batch (``d::D``, as the loader
splits them), draws the augmentation for the global batch and keeps its
rows, and with ``pp_stages`` S > 1 pipelines the model through
``parallel/pipeline.py``'s route for it (the BIT ``_dd8`` decoder, the
ChangeFormer V4-V6 MiT encoder, the ViG encoder; JAX's
stcd_tpu/train/trainer.py:216-272). BatchNorm, the losses and the counts sum
over the data group, the gradients are made whole across the stages and
averaged over the data shards (``pipeline.sync_gradients``); rank 0 writes
the checkpoints (in the one-process layout) and curves, every rank its log.
With ``tp_axis`` T > 1 the T ranks of a model group hold the same rows and
each a shard of the attention, MLP and wide-conv parameters and of their
optimizer moments (``parallel/tensor.py``): ``init_state`` places the state
as JAX's ``_init_state`` does (stcd_tpu/train/trainer.py:331-333), and
``train_models`` places it again after a resume (:426-429).

The steps take ``a`` and ``b`` as (N, H, W, 3) NHWC images, uint8 or float in
[0, 1], and ``label`` as (N, H, W, 1), all on the state's device, as the JAX
steps do; the models run NCHW inside. The state is mutable: ``train_step``
updates it in place and returns ``(loss, confusion counts)`` as tensors on
the device, so a step forces no host sync; the epoch loop adds them up there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from stcd_tpu_torch.data.augment import (eval_preprocess, sample_pair_params, to_float01,
                                         train_augment_pair)
from stcd_tpu_torch.data.io import save_mask_png
from stcd_tpu_torch.layers.modules import upsample_nearest
from stcd_tpu_torch.layers.stochastic import set_generator
from stcd_tpu_torch.losses import functional as L
from stcd_tpu_torch.metrics.confusion import (SegmentationMetric, confusion_matrix,
                                              global_counts)
from stcd_tpu_torch.models.factory import define_G, init_weights
from stcd_tpu_torch.parallel import distributed
from stcd_tpu_torch.parallel import pipeline as pp
from stcd_tpu_torch.parallel import tensor
from stcd_tpu_torch.parallel.mesh import Mesh, create_mesh, place_train_state
from stcd_tpu_torch.train.checkpoint import CheckpointManager
from stcd_tpu_torch.train.loops import _device_batch
from stcd_tpu_torch.train.schedules import Schedule, get_scheduler
from stcd_tpu_torch.train.state import (AdamConfig, AdamWConfig, OptimizerConfig, SGDConfig,
                                        TrainState, create_train_state)
from stcd_tpu_torch.train.steps import _own_rows, _row_map
from stcd_tpu_torch.utils.logging import ScalarLogger

# pixels of confusion counts summed on the device before they go to the host's
# float64 matrix (the JAX package's stcd_tpu/train/loops.py:45, where int32 cells
# would wrap past 2^31; the port's int64 cells would not, so the budget only
# bounds how long a device sum lives)
_CM_FLUSH_PIXEL_BUDGET = 1 << 30


@dataclasses.dataclass
class TrainerConfig:
    """The args object of the reference trainer, as the JAX package keeps it.
    ``dtype`` is None or ``torch.float32`` for float32, ``torch.bfloat16`` for
    bf16 autocast with float32 weights. ``device`` is where ``train_models``
    and ``CDEvaluator`` put the state: the card unless the caller asks for
    the CPU. ``pp_stages`` S > 1 pipelines the model over S ranks of the
    launch (``pp_microbatches`` microbatches a step, 0: S); ``tp_axis`` T > 1
    splits its wide parameters over T ranks (``parallel/tensor.py``)."""

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
    checkpoint_dir: str = "checkpoints"
    vis_dir: str = "vis"
    batch_size: int = 8
    seed: int = 1337
    dtype: Any = None
    # ``normalize`` applies ImageNet mean/std inside the step; ``augment``
    # applies the train-time photometric pipeline (one jitter coin per pair)
    # to training batches and always ends in normalisation.
    normalize: bool = True
    augment: bool = False
    pp_stages: int = 1
    pp_microbatches: int = 0
    tp_axis: int = 1
    device: str = "cuda"


def get_alpha_from_loader(loader) -> np.ndarray:
    """The class-occurrence scan of the reference's get_alpha over a train
    loader (``losses.functional.get_alpha``)."""
    return L.get_alpha(loader)


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
    ``init_state``, ``train_step``, ``eval_step`` and the epoch loop
    ``train_models`` over ``dataloaders`` (``{"train": ..., "val": ...}``, any
    iterables of dict batches with a length). The schedules are per epoch, of
    ``len(dataloaders["train"])`` steps, or of ``steps_per_epoch`` where no
    loaders are given. ``alpha`` is the class counts of the losses fl and
    miou; None scans the train loader for them when the loop starts.

    In a process group the trainer makes the data x model x stage grid of
    the launch (module docstring); the loaders and the steps' tensors are this
    rank's rows of the global batch. ``pp_stages`` > 1 with a model that
    no route pipelines raises JAX's NotImplementedError, and so does a
    stage count that the model does not allow (``pipeline.check_stages``)."""

    def __init__(self, cfg: TrainerConfig, dataloaders: Optional[dict] = None,
                 alpha=None, steps_per_epoch: Optional[int] = None):
        self.cfg = cfg
        self.dataloaders = dataloaders or {}
        self.alpha = alpha
        self.model = define_G(cfg.net_G, n_class=cfg.n_class, embed_dim=cfg.embed_dim,
                              img_size=cfg.img_size)
        self.stage_params: list = []
        if cfg.pp_stages > 1:
            pp.pipeline_route(self.model, cfg.net_G)
            pp.check_stages(self.model, cfg.pp_stages)
        self.mesh = _grid(cfg.pp_stages, cfg.tp_axis)
        if cfg.pp_stages > 1:
            pp.set_pipeline(self.model, cfg.pp_microbatches or None)
            self.stage_params = pp.stage_parameters(self.model)
        if steps_per_epoch is None:
            steps_per_epoch = len(self.dataloaders["train"]) if "train" in self.dataloaders else 1
        schedule = get_scheduler(cfg.lr_policy, cfg.lr, max(steps_per_epoch, 1),
                                 max_epochs=cfg.max_epochs,
                                 lr_decay_iters=cfg.lr_decay_iters)
        self.tx = _make_optimizer(cfg, schedule)
        self.best_val_acc = 0.0
        self.best_epoch_id = 0
        self.epoch_to_start = 0

    def init_state(self, device="cuda", init_seed: Optional[int] = None) -> TrainState:
        """The model on ``device`` with its optimizer and a generator seeded
        with ``cfg.seed`` for the steps' draws. ``init_seed`` gives seeded
        random weights (``models.factory.init_weights``, on the whole model:
        a split one is gathered first); None keeps the weights the modules
        hold. With a model axis the state is placed (``place_train_state``),
        each rank keeping its shards."""
        if init_seed is not None:
            if tensor.is_split(self.model):
                tensor.unsplit_model(self.model)
            init_weights(self.model, init_seed)
        state = create_train_state(self.model, self.tx, device=device,
                                   bf16=self.cfg.dtype == torch.bfloat16,
                                   seed=self.cfg.seed)
        if self.mesh.model > 1:
            place_train_state(self.mesh, state)
        return state

    def _global(self, loss: torch.Tensor, cm: torch.Tensor):
        """The loss averaged and the counts summed over the data shards."""
        if not distributed.data_parallel():
            return loss, cm
        mean = distributed.all_reduce_(loss.detach().double().reshape(1)) / self.mesh.data
        return mean[0].to(loss.dtype), global_counts(cm)

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
        """One update of ``state`` in place; returns ``(loss, cm)``, of the
        global batch. The augmentation's draws, every dropout and DropPath
        mask and the attention seeds come from the state's generator, which
        ``init_state`` seeds; in a process group they are drawn for the global
        batch and each rank keeps its rows."""
        cfg = self.cfg
        gen = state.generator
        n = a.shape[0]
        model = set_generator(state.model.train(), gen, _row_map(n, a.device))
        if cfg.augment:
            if gen is None:
                raise ValueError("augment=True needs a state with a generator: build "
                                 "it with CDTrainer.init_state")
            draws = sample_pair_params(gen, n * distributed.data_size(), 0.5)
            a, b = train_augment_pair(gen, a, b, aug_params=_own_rows(draws))
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
        pp.sync_gradients(model, self.stage_params)
        state.apply_gradients()
        _, cm = self._counts([p.detach() for p in preds], label)
        return self._global(loss.detach(), cm)

    @torch.no_grad()
    def eval_step(self, state: TrainState, a: torch.Tensor, b: torch.Tensor,
                  label: torch.Tensor):
        """Eval mode, no grad; returns ``(final NCHW prediction, cm)``, the
        prediction of this rank's rows and the counts of the global batch."""
        cfg = self.cfg
        model = state.model.eval()
        if cfg.normalize or cfg.augment:
            a, b = eval_preprocess(a), eval_preprocess(b)
        else:
            a, b = to_float01(a), to_float01(b)
        with state.autocast():
            preds = _as_list(model(_nchw(a), _nchw(b)))
        final, cm = self._counts(preds, _nchw(label))
        return final, global_counts(cm)

    # --- the epoch loop ---
    @staticmethod
    def scores(metric: SegmentationMetric) -> dict:
        """The reference's ConfuseMatrixMeter.get_scores: acc, miou, mf1 and the
        per-class entries."""
        f1 = metric.F1score()
        iou = metric.IntersectionOverUnion()
        return {
            "acc": float(metric.OverallAccuracy()),
            "miou": float(np.nanmean(iou)),
            "mf1": float(np.nanmean(f1)),
            "iou_0": float(iou[0]), "iou_1": float(iou[-1]),
            "F1_0": float(f1[0]), "F1_1": float(f1[-1]),
            "precision_1": float(metric.Precision()[-1]),
            "recall_1": float(metric.Recall()[-1]),
        }

    def _run_epoch(self, state: TrainState, loader, training: bool):
        """One pass over ``loader``: ``(metric, mean loss)``. The losses and the
        confusion counts are summed on the device, and the counts go to the
        host each ``_CM_FLUSH_PIXEL_BUDGET`` pixels and at the end, so no step
        waits for the host."""
        metric = SegmentationMetric(self.cfg.n_class)
        loss_sum, n_steps = None, 0
        cm_dev, px_acc = None, 0
        for batch in loader:
            batch, _ = _device_batch(batch, state.device)
            a, b, label = batch["A"], batch["B"], batch["label"].float()
            if training:
                loss, cm = self.train_step(state, a, b, label)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                n_steps += 1
            else:
                _, cm = self.eval_step(state, a, b, label)
            cm_dev = cm if cm_dev is None else cm_dev + cm
            px_acc += int(np.prod(label.shape[:3]))
            if px_acc >= _CM_FLUSH_PIXEL_BUDGET:
                metric.confusionMatrix += cm_dev.cpu().numpy().astype(np.float64)
                cm_dev, px_acc = None, 0
        if cm_dev is not None:
            metric.confusionMatrix += cm_dev.cpu().numpy().astype(np.float64)
        return metric, float(loss_sum) / n_steps if n_steps else 0.0

    def _ensure_alpha(self) -> None:
        if self.cfg.loss in ("fl", "miou") and self.alpha is None:
            self.alpha = get_alpha_from_loader(self.dataloaders["train"])

    def train_models(self) -> TrainState:
        """The reference trainer's train/val loop (its trainer.py:316-371):
        resumes from ``{checkpoint_dir}/last_ckpt`` when one exists (weights,
        optimizer, step, epoch, best), else starts from weights seeded with
        ``cfg.seed``; each epoch trains, evaluates, saves ``best_ckpt`` when the
        val mF1 beats the best so far and ``last_ckpt`` always, extends the
        ``train_acc.npy`` and ``val_acc.npy`` curves (the saved ones up to the
        resumed epoch first) and logs the scalars. Returns the state."""
        cfg = self.cfg
        self._ensure_alpha()
        ckpt = CheckpointManager(cfg.checkpoint_dir)
        logger = ScalarLogger(os.path.join(cfg.checkpoint_dir, "logs"))
        state = self.init_state(cfg.device, init_seed=cfg.seed)
        train_curve, val_curve = [], []
        restored = ckpt.restore_last(state, "last_ckpt")
        if restored is not None:
            state, last_epoch, self.best_val_acc, self.best_epoch_id = restored
            self.epoch_to_start = last_epoch + 1
            for name, curve in (("train_acc.npy", train_curve), ("val_acc.npy", val_curve)):
                path = os.path.join(cfg.checkpoint_dir, name)
                if os.path.exists(path):
                    curve.extend(np.load(path)[:self.epoch_to_start].tolist())
        place_train_state(self.mesh, state)
        try:
            for epoch_id in range(self.epoch_to_start, cfg.max_epochs):
                m, loss = self._run_epoch(state, self.dataloaders["train"], training=True)
                tr = self.scores(m)
                train_curve.append(tr["mf1"])
                logger.add_scalar("train/mf1", tr["mf1"], epoch_id)
                logger.add_scalar("train/loss", loss, epoch_id)

                m, _ = self._run_epoch(state, self.dataloaders["val"], training=False)
                va = self.scores(m)
                val_curve.append(va["mf1"])
                for k, v in va.items():
                    logger.add_scalar(f"val/{k}", v, epoch_id)

                if va["mf1"] > self.best_val_acc:
                    self.best_val_acc = va["mf1"]
                    self.best_epoch_id = epoch_id
                    ckpt.save_last(state, epoch_id, self.best_val_acc, self.best_epoch_id,
                                   name="best_ckpt")
                ckpt.save_last(state, epoch_id, self.best_val_acc, self.best_epoch_id,
                               name="last_ckpt")
                for name, curve in (("train_acc.npy", train_curve),
                                    ("val_acc.npy", val_curve)):
                    if distributed.is_primary():
                        np.save(os.path.join(cfg.checkpoint_dir, name),
                                np.asarray(curve, np.float32))
                logger.flush()
        finally:
            logger.close()
        return state


def _grid(stages: int, model: int) -> Mesh:
    """The launch's data x model x stage grid: the one the process group has
    where its stage and model axes are ``stages`` and ``model`` already (a
    trainer and its evaluator share it), else a new one (``create_mesh``,
    which raises where the launch does not divide)."""
    if (distributed.stage_size() == stages and distributed.model_size() == model
            and distributed.space_size() == 1
            and (stages * model > 1 or not distributed.data_parallel())):
        return Mesh(distributed.data_size(), distributed.rank(), 1, stages, model)
    return create_mesh(model=model, stage=stages)


class CDEvaluator:
    """The reference's evaluator (its models/evaluator.py:19-193): a
    checkpoint's weights, the eval loop with the scores, the predicted masks
    written to ``cfg.vis_dir``."""

    def __init__(self, cfg: TrainerConfig, dataloader):
        self.cfg = cfg
        self.dataloader = dataloader
        self.trainer = CDTrainer(cfg, {"train": dataloader, "val": dataloader})

    def load(self, ckpt_name: str = "best_ckpt") -> TrainState:
        """A state with the weights of ``{checkpoint_dir}/{ckpt_name}``. The
        load is weights-only (the module's parameters and BatchNorm buffers), so
        an evaluator whose config names another optimizer than the run that
        wrote the file reads it. The JAX evaluator falls back to a complete
        ``<name>.new`` left by a crash inside its directory swap; the port writes
        each checkpoint as one file renamed over its target
        (``train/checkpoint.py``), which leaves the old file or the new one and
        no ``.new`` window, so there is nothing to fall back to."""
        path = os.path.join(self.cfg.checkpoint_dir, ckpt_name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {ckpt_name} in {self.cfg.checkpoint_dir}")
        state = self.trainer.init_state(self.cfg.device)
        return CheckpointManager(self.cfg.checkpoint_dir).load_weights(state, path)

    def eval_models(self, ckpt_name: str = "best_ckpt", save_vis: bool = True) -> dict:
        """The scores of ``ckpt_name`` over the loader (over every rank's rows
        in a process group). With ``save_vis`` each named sample's predicted
        classes go to ``{vis_dir}/{name}`` as a PNG (class ids spread over
        0..255: {0, 255} for two classes), from the rank that holds it (stage
        0 and model index 0 of its data shard)."""
        state = self.load(ckpt_name)
        metric = SegmentationMetric(self.cfg.n_class)
        os.makedirs(self.cfg.vis_dir, exist_ok=True)
        denom = max(self.cfg.n_class - 1, 1)
        for batch in self.dataloader:
            batch, names = _device_batch(batch, state.device)
            final, cm = self.trainer.eval_step(state, batch["A"], batch["B"],
                                               batch["label"].float())
            metric.confusionMatrix += cm.cpu().numpy().astype(np.float64)
            if save_vis and names is not None and distributed.stage_rank() == 0 and (
                    distributed.model_rank() == 0):
                preds = self.trainer._pred_to_labels(final).cpu().numpy()
                for i, name in enumerate(names):
                    save_mask_png(preds[i].astype(np.float32) / denom,
                                  os.path.join(self.cfg.vis_dir, name))
        return CDTrainer.scores(metric)
