"""Checkpoints with the reference's artifact names (counterpart of
stcd_tpu/train/checkpoint.py): the full resume point ``last_ckpt`` (module,
optimizer, step, epoch, best metric), the best-metric artifact
``%.2f_best_model`` (metric x 100, only the current best is kept) and the epoch
snapshots ``%.2f_model``.

Each artifact is one ``torch.save`` file where the JAX package writes an
orbax directory of the same name. A file is written whole under a temporary
name and renamed over its target, so a crash leaves the old artifact or the
new one, never a partial one. The schedule is a function of the step count,
so the step is the scheduler's position. Not ported: ``repair`` (the swap
windows of a directory checkpoint do not exist for a renamed file).

Data parallel (``parallel.distributed``): every rank holds the same state,
so only rank 0 writes (``_is_primary``), on a file system that the ranks
share, and every save ends at a barrier (``_barrier``), after which every
rank sees the new file. Every rank loads the same bytes.

Tensor parallel (``parallel/tensor.py``): a file holds the one-process
layout. Before rank 0 writes, every rank gathers its model group's shards
(the parameters and their optimizer moments, ``kv`` and ``to_qkv`` back in
their head order); a load into a split model keeps this rank's shard of
the full tensors. So a file written under a model axis loads in one
process, and the reverse, as the JAX package's orbax checkpoints hold
global arrays.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import torch

from stcd_tpu_torch.parallel import distributed, tensor


def _is_primary() -> bool:
    return distributed.is_primary()


def _barrier(name: str) -> None:
    """Every rank waits for rank 0's write (no-op in one process)."""
    distributed.barrier("stcd_ckpt_" + name)


def _save_atomic(payload: dict, path: str) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load(path: str, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # --- full resume ---
    def save_last(self, state, epoch_id: int, best_val_acc: float, best_epoch_id: int,
                  name: str = "last_ckpt") -> str:
        path = os.path.join(self.directory, name)
        model = tensor.full_state_dict(state.model)
        optimizer = tensor.full_optimizer_state_dict(state.optimizer, state.model)
        if _is_primary():
            _save_atomic({
                "epoch_id": int(epoch_id),
                "best_val_acc": float(best_val_acc),
                "best_epoch_id": int(best_epoch_id),
                "model": model,
                "optimizer": optimizer,
                "step": int(state.step),
            }, path)
        _barrier("save_last")
        return path

    def restore_last(self, state, name: str = "last_ckpt"):
        """Load the resume point into ``state`` in place. Returns
        ``(state, epoch_id, best_val_acc, best_epoch_id)``, or None when there
        is no such checkpoint."""
        path = os.path.join(self.directory, name)
        if not os.path.exists(path):
            return None
        restored = _load(path, state.device)
        state.model.load_state_dict(tensor.split_state_dict(state.model, restored["model"]),
                                    strict=True)
        state.optimizer.load_state_dict(tensor.split_optimizer_state_dict(
            state.optimizer, state.model, restored["optimizer"]))
        state.step = int(restored["step"])
        return (state, int(restored["epoch_id"]), float(restored["best_val_acc"]),
                int(restored["best_epoch_id"]))

    # --- weights-only artifacts ---
    def save_best(self, state, metric: float) -> str:
        """Keep only the current best, named ``%.2f_best_model`` (x 100). The
        new best is in place before the old one is deleted."""
        path = os.path.join(self.directory, "%.2f_best_model" % (metric * 100))
        model = tensor.full_state_dict(state.model)
        if _is_primary():
            _save_atomic({"model": model}, path)
            for old in glob.glob(os.path.join(self.directory, "*_best_model")):
                if old != path:
                    os.remove(old)
        _barrier("save_best")
        return path

    def save_snapshot(self, state, epoch: int) -> str:
        path = os.path.join(self.directory, "%.2f_model" % epoch)
        model = tensor.full_state_dict(state.model)
        if _is_primary():
            _save_atomic({"model": model}, path)
        _barrier("save_snapshot")
        return path

    def load_weights(self, state, path: str):
        """Weights-only load (parameters and BatchNorm buffers) into ``state``
        in place; the optimizer and the step stay."""
        state.model.load_state_dict(
            tensor.split_state_dict(state.model, _load(path, state.device)["model"]),
            strict=True)
        return state

    def best_path(self) -> Optional[str]:
        cands = sorted(glob.glob(os.path.join(self.directory, "*_best_model")))
        return cands[-1] if cands else None
