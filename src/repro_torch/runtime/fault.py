"""Fault tolerance of the train loop: the port's copy of the train-side
parts of ``repro.runtime.fault`` (pure Python).

* ``StragglerDetector``: EWMA of per-step wall time; flags a step that
  takes more than ``ratio`` x the EWMA.
* ``PreemptionGuard``: a SIGTERM handler that flips a flag; the train loop
  checkpoints and exits cleanly inside the grace period.
* ``RestartableLoop``: drives the step counter and the checkpoint cadence,
  so a crash at any point resumes bit-identically (the data stream seeks
  in O(1)).

``Heartbeat`` and ``FaultInjector`` belong to the serving frontend, which
is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class StragglerDetector:
    """EWMA step-time monitor; `check` returns True when this step is a
    straggler (> ratio x EWMA)."""

    def __init__(self, alpha: float = 0.1, ratio: float = 3.0, warmup: int = 5):
        self.alpha, self.ratio, self.warmup = alpha, ratio, warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged = 0

    def check(self, step_time: float) -> bool:
        self.n += 1
        if self.ewma is None:
            self.ewma = step_time
            return False
        is_straggler = (self.n > self.warmup
                        and step_time > self.ratio * self.ewma)
        if is_straggler:
            self.flagged += 1
        else:  # don't pollute the EWMA with outliers
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return is_straggler


class PreemptionGuard:
    """SIGTERM -> graceful save.  Use as context manager around the loop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._signals = signals
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class RestartableLoop:
    """Checkpoint-cadenced train loop driver.

    `body(step) -> metrics` runs one step; the loop handles resume offset,
    periodic async checkpointing via the provided callback, straggler
    logging, and preemption-triggered final save.
    """

    def __init__(self, total_steps: int, ckpt_every: int,
                 save_cb: Callable[[int], None],
                 start_step: int = 0,
                 straggler: Optional[StragglerDetector] = None,
                 guard: Optional[PreemptionGuard] = None):
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.save_cb = save_cb
        self.start_step = start_step
        self.straggler = straggler or StragglerDetector()
        self.guard = guard
        self.stragglers = []

    def run(self, body: Callable[[int], dict]):
        last = self.start_step
        saved = None
        for step in range(self.start_step, self.total_steps):
            t0 = time.time()
            metrics = body(step)
            dt = time.time() - t0
            if self.straggler.check(dt):
                self.stragglers.append((step, dt))
            last = step + 1
            if last % self.ckpt_every == 0:
                self.save_cb(last)
                saved = last
            if self.guard is not None and self.guard.requested:
                break
        # final save only when the cadence didn't already cover `last` —
        # a loop that exits (normally or preempted) right on a ckpt_every
        # boundary must not write the same step twice
        if saved != last:
            self.save_cb(last)
        return last
