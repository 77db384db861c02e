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
windows of a directory checkpoint do not exist for a renamed file) and the
multi-process barriers.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import torch


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
        return _save_atomic({
            "epoch_id": int(epoch_id),
            "best_val_acc": float(best_val_acc),
            "best_epoch_id": int(best_epoch_id),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
        }, os.path.join(self.directory, name))

    def restore_last(self, state, name: str = "last_ckpt"):
        """Load the resume point into ``state`` in place. Returns
        ``(state, epoch_id, best_val_acc, best_epoch_id)``, or None when there
        is no such checkpoint."""
        path = os.path.join(self.directory, name)
        if not os.path.exists(path):
            return None
        restored = _load(path, state.device)
        state.model.load_state_dict(restored["model"], strict=True)
        state.optimizer.load_state_dict(restored["optimizer"])
        state.step = int(restored["step"])
        return (state, int(restored["epoch_id"]), float(restored["best_val_acc"]),
                int(restored["best_epoch_id"]))

    # --- weights-only artifacts ---
    def save_best(self, state, metric: float) -> str:
        """Keep only the current best, named ``%.2f_best_model`` (x 100). The
        new best is in place before the old one is deleted."""
        path = _save_atomic({"model": state.model.state_dict()},
                            os.path.join(self.directory, "%.2f_best_model" % (metric * 100)))
        for old in glob.glob(os.path.join(self.directory, "*_best_model")):
            if old != path:
                os.remove(old)
        return path

    def save_snapshot(self, state, epoch: int) -> str:
        return _save_atomic({"model": state.model.state_dict()},
                            os.path.join(self.directory, "%.2f_model" % epoch))

    def load_weights(self, state, path: str):
        """Weights-only load (parameters and BatchNorm buffers) into ``state``
        in place; the optimizer and the step stay."""
        state.model.load_state_dict(_load(path, state.device)["model"], strict=True)
        return state

    def best_path(self) -> Optional[str]:
        cands = sorted(glob.glob(os.path.join(self.directory, "*_best_model")))
        return cands[-1] if cands else None
