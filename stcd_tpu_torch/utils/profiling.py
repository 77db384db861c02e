"""Profiling helpers (counterpart of stcd_tpu/utils/profiling.py): a
``torch.profiler`` trace written as a Chrome trace, and a step timer."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's host and device activity with ``torch.profiler``
    and write it to ``{logdir}/trace.json`` (chrome://tracing, Perfetto).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-step wall-clock accumulator for steps/s. The caller synchronises
    the device inside the block where a step's device time should count."""

    def __init__(self):
        self.times = []
        self._t = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t)

    def steps_per_sec(self):
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)
