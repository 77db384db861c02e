"""Batching with threaded decode and asynchronous copies to the card
(counterpart of stcd_tpu/data/loader.py).

A thread pool decodes the samples of a batch (the native decoder releases the
interpreter lock), the arrays are stacked on the host and the batch goes to
``device``. On a card the arrays are stacked straight into pinned host
tensors and copied with ``non_blocking=True`` on a side stream, with two
batches in flight, so the next batch's copy overlaps the step on the current
one. Before a batch is handed out, the consumer's stream waits for its copy,
and each of its tensors is marked used on that stream (``record_stream``), so
the caching allocator cannot give its memory to another tensor while the
consumer's kernels may still read it.

The index order is the JAX loader's (``np.random.default_rng(seed + epoch)``
shuffles each epoch), and so are ``__len__``, ``drop_last``, the partial final
batch and the ``name`` lists. One process only: the strided split of the data
over processes is ROADMAP.md Queue 1 #10.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Any, Dict, Iterator, Sequence

import numpy as np
import torch

from stcd_tpu_torch.cli.predict import resolve_device

PREFETCH = 2  # batches whose copy is in flight on the card


def _stack(samples: Sequence[Dict[str, Any]], pin: bool = False) -> Dict[str, Any]:
    """One batch from its samples: each array key stacked into a host tensor
    (pinned when ``pin``), any other key (``name``) as a list."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            dtype = torch.from_numpy(np.empty(0, vals[0].dtype)).dtype
            buf = torch.empty((len(vals), *vals[0].shape), dtype=dtype, pin_memory=pin)
            np.stack(vals, out=buf.numpy())
            out[key] = buf
        else:
            out[key] = vals
    return out


class DataLoader:
    """Epoch-based loader: shuffle, batch, threaded decode, copies to ``device``.

    ``device`` is ``"cuda"`` unless the caller asks for the CPU; ``cuda``
    without a card raises. On the CPU the batches are host tensors."""

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False, seed: int = 1337,
                 device="cuda", process_index: int = None, process_count: int = None):
        if (process_index is None) != (process_count is None):
            raise ValueError(
                "pass process_index AND process_count together (got "
                f"process_index={process_index}, process_count={process_count})")
        if process_count is not None and process_count > 1:
            raise NotImplementedError(
                f"process_count={process_count}: the loader's split over processes is not "
                "ported (ROADMAP.md Queue 1 #10)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.device = resolve_device(device)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        return idx

    def _host_batches(self, pin: bool) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(len(self)):
                sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                yield _stack(list(pool.map(self.dataset.__getitem__, sel)), pin=pin)

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self._host_batches(pin=False)
            return
        copy_stream = torch.cuda.Stream(self.device)
        queue = collections.deque()
        for host in self._host_batches(pin=True):
            queue.append(self._start_copy(host, copy_stream))
            if len(queue) >= PREFETCH:
                yield self._hand_out(*queue.popleft())
        while queue:
            yield self._hand_out(*queue.popleft())

    def _start_copy(self, host: Dict[str, Any], stream: torch.cuda.Stream):
        """Start the batch's copies on ``stream``; returns what ``_hand_out``
        needs, the pinned host tensors included, which stay referenced until
        the batch is handed out."""
        with torch.cuda.stream(stream):
            batch = {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                     for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(stream)
        return batch, copied, host

    def _hand_out(self, batch: Dict[str, Any], copied: torch.cuda.Event, host) -> Dict[str, Any]:
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(copied)
        for v in batch.values():
            if torch.is_tensor(v):
                v.record_stream(consumer)
        return batch
