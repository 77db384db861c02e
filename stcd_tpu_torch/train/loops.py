"""Epoch-level training loop of the three STCD stages and its utilities
(counterpart of stcd_tpu/train/loops.py): ``run_training``, ``evaluate``,
``generate_pseudo_labels`` and ``select_reliable``.

The loop has the reference's shape: an optimizer step per iteration with the
schedule on the global step, an eval per epoch with the confusion-matrix
metrics, the best checkpoint by class-1 IoU, snapshots at n/3, 2n/3 and n.

A loader is any iterable of dict batches (numpy arrays or tensors, with an
optional ``name`` list); each batch is moved to the state's device here. The
steps return their confusion counts as int64 tensors on the device, and the
loop adds them there and brings them to the host once an epoch, so between
the ``log_every`` steps it forces no host sync. The JAX loop flushes its int32
counts on a pixel budget; int64 cells hold 9e18 pixels, so the port keeps no
budget.

Data parallel (``parallel.distributed``): every rank runs the same loop on
its share of the data. The train steps return global losses and counts;
``evaluate`` sums its counts over the ranks; the checkpoints are written by
rank 0 (train/checkpoint.py); only rank 0 prints, and each rank keeps its
own scalar log (utils/logging.py). ``generate_pseudo_labels`` and
``select_reliable`` run their loader whole on every rank, so rank 0 writes
what one process would.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from stcd_tpu_torch.data.io import save_jet_png, save_mask_png, write_list
from stcd_tpu_torch.metrics.confusion import SegmentationMetric, global_counts
from stcd_tpu_torch.parallel import distributed
from stcd_tpu_torch.train.checkpoint import CheckpointManager
from stcd_tpu_torch.utils.logging import ScalarLogger, Throughput


def _epoch_metrics(metric: SegmentationMetric) -> Dict[str, float]:
    return {
        "OA": float(metric.OverallAccuracy()),
        "precision": float(metric.Precision()[1]),
        "recall": float(metric.Recall()[1]),
        "F1": float(metric.F1score()[1]),
        "IoU": float(metric.IntersectionOverUnion()[1]),
        "mIoU": float(metric.meanIntersectionOverUnion()),
    }


def _device_batch(batch, device):
    """(the batch's arrays as tensors on ``device``, its ``name`` list or None)."""
    batch = dict(batch)
    names = batch.pop("name", None)
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}, names


def _add_counts(metric: SegmentationMetric, cm_dev) -> None:
    if cm_dev is not None:
        metric.confusionMatrix += cm_dev.cpu().numpy().astype(np.float64)


def run_training(train_step, eval_step, state, train_loader, eval_loader,
                 n_epochs: int, save_dir: str, rng: Optional[torch.Generator],
                 log_every: int = 10, eval_key: str = "IoU",
                 snapshot_epochs: Optional[set] = None,
                 logger: Optional[ScalarLogger] = None,
                 preemption=None, start_epoch: int = 1,
                 best: float = -1.0, best_epoch: int = 0):
    """The stage driver that all three stages share. Returns
    ``(state, best_metric, history)``.

    ``rng`` is the one ``torch.Generator`` (on the state's device) that every
    train step draws its augmentation from; None where the steps were built
    with ``augment=False``.

    ``preemption``: an object with ``should_stop()``. When it says so, the
    loop saves a full resume point (``save_last``) and returns early; the
    interrupted epoch is not counted, so restarting with ``start_epoch``,
    ``best`` and ``best_epoch`` from ``restore_last`` runs it again.
    ``best=-1.0``: the first epoch always saves a best artifact, even at
    IoU 0."""
    ckpt = CheckpointManager(save_dir)
    logger = logger or ScalarLogger(os.path.join(save_dir, "logs"))
    if snapshot_epochs is None:
        snapshot_epochs = {n_epochs // 3, n_epochs * 2 // 3, n_epochs}

    def score(em):
        return 0.0 if np.isnan(em[eval_key]) else float(em[eval_key])

    history = []
    meter = Throughput()
    # the scalar log's step axis goes on from a restored state's step
    global_step = int(state.step)
    device = state.device
    for epoch in range(start_epoch, n_epochs + 1):
        meter.reset()  # a per-epoch rate, without the last epoch's eval and saves
        train_metric = SegmentationMetric(2)
        cm_dev = None
        for batch in train_loader:
            if preemption is not None and preemption.should_stop():
                _add_counts(train_metric, cm_dev)
                ckpt.save_last(state, epoch - 1, best, best_epoch)
                logger.flush()
                distributed.print_primary(f"preemption: saved resume point at epoch "
                                          f"{epoch - 1}; restart from restore_last")
                return state, best, history
            batch, _ = _device_batch(batch, device)
            out = train_step(state, batch, rng)
            cm_dev = out["cm"] if cm_dev is None else cm_dev + out["cm"]
            meter.update(next(iter(batch.values())).shape[0] * distributed.data_size())
            if global_step % log_every == 0:
                logger.add_scalar("train/loss", float(out["loss"]), global_step)
                for k in ("seg_loss", "cd_loss", "ct_loss"):
                    if k in out:
                        logger.add_scalar(f"train/{k}", float(out[k]), global_step)
            global_step += 1
        _add_counts(train_metric, cm_dev)
        tm = _epoch_metrics(train_metric)
        logger.add_scalar("train/F1", tm["F1"], epoch)
        logger.add_scalar("train/IoU", tm["IoU"], epoch)
        logger.add_scalar("train/imgs_per_sec", meter.rate(), epoch)

        em = evaluate(eval_step, state, eval_loader)
        for k, v in em.items():
            logger.add_scalar(f"val/{k}", v, epoch)
        history.append({"epoch": epoch, "train": tm, "val": em})
        if score(em) > best:
            best = score(em)
            best_epoch = epoch
            ckpt.save_best(state, best)
        if epoch in snapshot_epochs:
            ckpt.save_snapshot(state, epoch)
        ckpt.save_last(state, epoch, best, best_epoch)
        logger.flush()
    return state, best, history


def evaluate(eval_step, state, eval_loader) -> Dict[str, float]:
    """The metrics of ``eval_step``'s counts over the loader, summed over the
    ranks of a data-parallel run (each rank's loader holds its share; a
    loader that gives every rank the whole set gives W times every count,
    and the same metrics; under a space axis each rank counts its strips)."""
    metric = SegmentationMetric(2)
    cm_dev = torch.zeros((2, 2), dtype=torch.int64, device=state.device)
    for batch in eval_loader:
        batch, _ = _device_batch(batch, state.device)
        cm_dev = cm_dev + eval_step(state, batch)["cm"]
    _add_counts(metric, global_counts(cm_dev))
    return _epoch_metrics(metric)


def generate_pseudo_labels(eval_step, state, loader, out_dir: str,
                           threshold: float = 0.7,
                           vis_dir: Optional[str] = None) -> Dict[str, float]:
    """Thresholded sigmoid(change logit) saved as PNG x 255 under each
    sample's name; returns the metrics against the batches' labels. With
    ``vis_dir`` the raw probability map is saved there too, jet-coloured."""
    metric = SegmentationMetric(2)
    write = distributed.is_primary()
    os.makedirs(out_dir, exist_ok=True)
    for batch in loader:
        labels = np.asarray(torch.as_tensor(batch["label"]).cpu()).astype(np.int64)
        batch, names = _device_batch(batch, state.device)
        probs = eval_step(state, batch)["probs"].float().cpu().numpy()
        preds = (probs > threshold).astype(np.uint8)
        metric.addBatch(preds.astype(np.int64), labels)
        for i, name in enumerate(names if write else ()):
            save_mask_png(preds[i], os.path.join(out_dir, name))
            if vis_dir:
                save_jet_png(probs[i], os.path.join(vis_dir, name))
    distributed.barrier("generate_pseudo_labels")
    return _epoch_metrics(metric)


def select_reliable(eval_steps, states, loader, list_dir: str):
    """Ensemble reliability ranking: for each sample, the mean IoU between
    each earlier model's prediction and the last model's ranks its stability;
    the top half goes to ``reliable_ids.txt``, the rest to
    ``unreliable_ids.txt``. ``states``: states from different epochs, each
    with its eval step. Returns the ranked ``(name, reliability)`` list."""
    if len(states) < 2:
        raise ValueError(
            "reliability ranking needs >= 2 model states (the reference uses 3 epoch "
            f"snapshots + the current model); got {len(states)}: are the *_model "
            "snapshots missing?")
    id_to_reliability = []
    for batch in loader:
        preds = []
        for eval_step, st in zip(eval_steps, states):
            on_device, names = _device_batch(batch, st.device)
            probs = eval_step(st, on_device)["probs"].float().cpu().numpy()
            preds.append((probs > 0.5).astype(np.int64))
        for i in range(preds[0].shape[0]):
            mious = []
            for k in range(len(preds) - 1):
                m = SegmentationMetric(2)
                m.addBatch(preds[k][i], preds[-1][i])
                mious.append(m.meanIntersectionOverUnion())
            id_to_reliability.append((names[i], float(np.mean(mious))))
    id_to_reliability.sort(key=lambda x: x[1], reverse=True)
    half = len(id_to_reliability) // 2
    if distributed.is_primary():
        write_list([i for i, _ in id_to_reliability[:half]],
                   os.path.join(list_dir, "reliable_ids.txt"))
        write_list([i for i, _ in id_to_reliability[half:]],
                   os.path.join(list_dir, "unreliable_ids.txt"))
    distributed.barrier("select_reliable")
    return id_to_reliability
