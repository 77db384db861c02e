"""Preemption-safe training (counterpart of stcd_tpu/train/preemption.py).

A machine that is preempted or taken for maintenance gets SIGTERM and a grace
window. The guard's signal handler flags the step loop, which saves a full
resume point (``CheckpointManager.save_last``: weights, optimizer, step,
epoch, best metric) and returns; the same command with ``--resume``
continues from the interrupted epoch.

One process: ``should_stop`` answers from the local flag at once. A caller
may pass ``global_or``, an OR of the flag over processes that every process
calls together; the guard then calls it every ``sync_every`` calls and
returns the last agreed value in between, as the JAX guard does across
hosts. The default OR over processes is ROADMAP.md Queue 1 #10.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional


class PreemptionGuard:
    """Installs signal handlers and answers "should this step loop stop?".

    Usage::

        guard = PreemptionGuard()           # installs the SIGTERM handler
        run_training(..., preemption=guard)
        if guard.fired:
            print("preempted: resume with --resume")

    ``signals``: the signals that flag a stop (default SIGTERM, the
    preemption notice; SIGINT is left to KeyboardInterrupt). ``install``:
    False uses the guard as a plain flag, set by ``trigger()``.
    ``global_or``/``sync_every``: see the module docstring."""

    def __init__(self, signals=(signal.SIGTERM,), sync_every: int = 16,
                 install: bool = True,
                 global_or: Optional[Callable[[bool], bool]] = None):
        self._flag = False
        self._agreed = False
        self._calls = 0
        self.sync_every = max(1, int(sync_every))
        self._global_or = global_or
        self._prev = {}
        self._installed = False
        if install:
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    "PreemptionGuard must be constructed in the main thread "
                    "(signal.signal requirement); pass install=False and "
                    "call trigger() from your own handler instead")
            for s in signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True

    def _handler(self, signum, frame):
        self._flag = True
        prev = self._prev.get(signum)
        # chain a Python-level handler that was there before, never the default
        # action, which would end the process before the save
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)

    def trigger(self) -> None:
        """Flag a stop programmatically (tests, external schedulers)."""
        self._flag = True

    def uninstall(self) -> None:
        """Restore the previous signal handlers."""
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._installed = False

    @property
    def fired(self) -> bool:
        """True once a stop has been agreed (what the step loop saw)."""
        return self._agreed

    def should_stop(self) -> bool:
        """Call once a train step. Sticky once True."""
        if self._agreed:
            return True
        if self._global_or is None:
            self._agreed = self._flag
            return self._agreed
        # the OR is a collective: it runs on a call count that is the same on
        # every process, never "when the local flag is set"
        self._calls += 1
        if self._calls % self.sync_every == 0:
            self._agreed = bool(self._global_or(self._flag))
        return self._agreed
