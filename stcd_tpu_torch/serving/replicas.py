"""One model replica a device, driven in turn from the calling thread: the
torch form of the JAX package's ``batch_sharding(create_mesh(model=1))``
placement of a serving batch (stcd_tpu/serving/server.py:178-183,
stcd_tpu/data/tiled_inference.py:84-92).

A batch of B rows is cut into D contiguous slices of B / D rows, in row
order, as ``NamedSharding(P("data"))`` cuts it over D devices; slice i goes
to replica i, and the outputs come back in row order. The calling thread
issues the D forwards one after another, each with its card as the current
device, and only then copies the outputs back: a card's kernels run while
the thread issues the next card's, so the cards overlap without a thread of
their own (worker threads a card took turns on Python's GIL and were slower,
PERF.md). A batch fails as a whole if any replica fails: its slice is never
run again on another device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch

from stcd_tpu_torch.utils.device import indexed_device, resolve_device


class Replicas:
    """``fns[i](*slices) -> probs`` on ``devices[i]``.

    ``fns[i]`` takes NHWC tensors on ``devices[i]`` and returns a tensor of as
    many rows. A device that names a card without an index is the calling
    thread's current card; ``cuda`` without a card raises."""

    def __init__(self, fns: Sequence[Callable], devices: Sequence):
        if len(fns) != len(devices) or not devices:
            raise ValueError(f"one predict function per device: {len(fns)} functions for "
                             f"{len(devices)} devices")
        self.fns = list(fns)
        self.devices = [indexed_device(resolve_device(str(d))) for d in devices]

    def run(self, *parts: np.ndarray) -> np.ndarray:
        """The replicas' outputs on ``parts`` (arrays of one row count, which
        the device count must divide), as float32 rows in the inputs' order.
        Every replica's forward is issued and every output collected before
        this returns; then the first failure, if any, is raised."""
        rows = parts[0].shape[0]
        n = len(self.devices)
        if rows % n:
            raise ValueError(f"{rows} rows do not divide across {n} devices")
        k = rows // n
        outs, failure = [], None
        with torch.inference_mode():
            for i, (fn, dev) in enumerate(zip(self.fns, self.devices)):
                on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                           else contextlib.nullcontext())
                try:
                    with on_card:
                        outs.append(fn(*[torch.from_numpy(p[i * k:(i + 1) * k]).to(dev)
                                         for p in parts]))
                except Exception as exc:  # the others still run: the batch fails whole
                    failure = failure or exc
            try:  # each copy back waits for its card alone
                host = [out.float().cpu().numpy() for out in outs]
            except Exception as exc:
                failure = failure or exc
        if failure is not None:
            raise failure
        return np.concatenate(host)
