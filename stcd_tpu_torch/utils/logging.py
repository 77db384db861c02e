"""Scalar logging and a throughput meter (counterpart of
stcd_tpu/utils/logging.py): a JSON-lines scalar log always, and a TensorBoard
writer beside it when ``torch.utils.tensorboard`` imports. In a
data-parallel run every rank logs (the scalars are the global ones on every
rank) into a file of its own, so that writes to a shared file system do not
interleave: rank 0 into ``scalars.jsonl``, rank r into ``scalars.p{r}.jsonl``.
Rank 0 alone has the TensorBoard writer."""

from __future__ import annotations

import json
import os
import time

from stcd_tpu_torch.parallel import distributed


class ScalarLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        rank = distributed.rank()
        self.path = os.path.join(logdir, "scalars.jsonl" if rank == 0
                                 else f"scalars.p{rank}.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard and rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except Exception:  # tensorboard is optional
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """Images per second since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._n = 0

    def update(self, n: int):
        self._n += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._n / dt if dt > 0 else 0.0
