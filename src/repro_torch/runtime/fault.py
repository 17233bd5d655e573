"""Fault tolerance of the train loop and the serving frontend: the port's
copy of ``repro.runtime.fault`` (pure Python and numpy).

* ``Heartbeat``: a per-host liveness file that a supervisor watches; a
  host that stops beating past ``timeout`` is declared dead.
* ``StragglerDetector``: EWMA of per-step wall time; flags a step that
  takes more than ``ratio`` x the EWMA.
* ``PreemptionGuard``: a SIGTERM handler that flips a flag; the train loop
  checkpoints and exits cleanly inside the grace period.
* ``RestartableLoop``: drives the step counter and the checkpoint cadence,
  so a crash at any point resumes bit-identically (the data stream seeks
  in O(1)).
* ``FaultInjector``: a seeded, deterministic fault schedule for the
  serving engine's step hook (crashes, injected straggler latency, NaN
  state corruption); what lets
  :class:`repro_torch.serving.ServingFrontend` pin its recovery path.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np


class Heartbeat:
    """Writes ``{"host": host_id, "t": time.time()}`` to ``path`` every
    ``interval`` seconds on a thread of its own (``start`` / ``stop``);
    each write replaces the file whole, so a reader never sees half of
    one."""

    def __init__(self, path: str, host_id: int = 0, interval: float = 1.0):
        self.path = path
        self.host_id = host_id
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self):
        while not self._stop.is_set():
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"host": self.host_id, "t": time.time()}, f)
            os.replace(tmp, self.path)
            self._stop.wait(self.interval)

    def start(self):
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    @staticmethod
    def is_alive(path: str, timeout: float) -> bool:
        """Whether ``path`` holds a beat younger than ``timeout`` seconds
        (False for a missing, unreadable or malformed file)."""
        try:
            with open(path) as f:
                return time.time() - json.load(f)["t"] < timeout
        except (OSError, ValueError, KeyError):
            return False


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


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` to simulate an engine-step crash
    (the serving analogue of a host vanishing mid-train-step)."""


class FaultInjector:
    """Seeded, deterministic fault schedule over engine dispatches.

    Usable as a :class:`repro_torch.serving.ContinuousEngine`
    ``step_hook`` (called once per dispatch with the engine).  Three fault
    kinds:

    * ``"crash"``     -- raise :class:`InjectedFault` before the dispatch
                         (the engine loses every in-flight request unless
                         a frontend recovers it);
    * ``"straggle"``  -- sleep ``straggle_s`` before the dispatch
                         (injected tail latency, visible in SLO p99s);
    * ``"nan"``       -- fill the engine's decode cache with NaN
                         (``engine.poison_cache()``): the next step's
                         logits go non-finite and the engine's health bit
                         trips before any token commits.

    Faults fire at explicit dispatch indices (``crash_steps`` et al.) or
    with seeded probabilities.  Every dispatch draws exactly three
    variates, so the schedule is a pure function of (seed, dispatch index)
    whichever faults fire, and is the reference's draw for draw.  An
    explicit index fires at most once (the dispatch counter passes it), so
    a recovered engine does not crash again on the same entry.
    """

    def __init__(self, seed: int = 0, *,
                 crash_steps: Sequence[int] = (),
                 nan_steps: Sequence[int] = (),
                 straggle_steps: Sequence[int] = (),
                 p_crash: float = 0.0, p_nan: float = 0.0,
                 p_straggle: float = 0.0, straggle_s: float = 0.02,
                 sleep: Callable[[float], None] = time.sleep):
        self.crash_steps = frozenset(crash_steps)
        self.nan_steps = frozenset(nan_steps)
        self.straggle_steps = frozenset(straggle_steps)
        self.p_crash, self.p_nan, self.p_straggle = p_crash, p_nan, p_straggle
        self.straggle_s = straggle_s
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self.step = -1            # dispatch counter (first dispatch is 0)
        self.log: list = []       # [(dispatch, kind), ...] of fired faults

    def next_fault(self) -> Optional[str]:
        """Advance the dispatch counter and return the fault kind for this
        dispatch (None for a clean one)."""
        self.step += 1
        u = self._rng.random(3)   # always 3 draws: the schedule is step-pure
        if self.step in self.crash_steps or u[0] < self.p_crash:
            return "crash"
        if self.step in self.nan_steps or u[1] < self.p_nan:
            return "nan"
        if self.step in self.straggle_steps or u[2] < self.p_straggle:
            return "straggle"
        return None

    def __call__(self, engine) -> None:
        kind = self.next_fault()
        if kind is None:
            return
        self.log.append((self.step, kind))
        if kind == "straggle":
            self._sleep(self.straggle_s)
        elif kind == "nan":
            engine.poison_cache()
        else:
            raise InjectedFault(f"injected engine crash at dispatch "
                                f"{self.step}")
