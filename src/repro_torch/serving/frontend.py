"""Fault-tolerant serving frontend over :class:`ContinuousEngine`
(counterpart of ``repro.serving.frontend``).

The engine runs in batch-drain mode: ``run()`` loops until a submitted
queue empties, and any failure is an exception that loses every in-flight
request.  ``ServingFrontend`` makes a server of it:

* **live intake** -- ``submit()`` is thread-safe and non-blocking; a
  feeder thread can add requests while the engine steps on the serve
  thread (``start()``) or while the caller drives ``step()``.  Admission
  is bounded by ``queue_cap``: overload is rejected with the queue depth in
  the ticket's error, instead of a queue that grows until deadlines make
  every response useless.
* **a typed terminal status per request** -- every request ends in exactly
  one of ``FINISHED / REJECTED / TIMED_OUT / CANCELLED / FAILED``
  (:class:`RequestStatus`), with its partial tokens and timing on its
  :class:`Ticket`.
* **deadlines and cancellation** -- TTFT and total deadlines are enforced
  at plan time, before each engine dispatch: an expired slot is evicted as
  an EOS slot is.  ``cancel(rid)`` covers queued and in-flight requests.
  Enforcement happens once a dispatch, so a deadline can overshoot by one
  dispatch (a ragged step, a burst or a speculative round).
* **fault recovery** -- a failed engine step (an injected crash from
  :class:`repro_torch.runtime.fault.FaultInjector`, the engine's
  non-finite-logits health bit ``EngineCorrupted``, or any other
  exception) is caught before it commits tokens.  The frontend clears the
  engine (``engine.reset()``: the caches are zeroed in place, so the
  captured CUDA graphs replay on, and no weight moves) and submits every
  in-flight request again as ``prompt + emitted`` with the rest of its
  ``max_new_tokens``.  Greedy decode is deterministic, so the recovered
  streams are the unfaulted ones token for token.
* **graceful drain** -- a :class:`~repro_torch.runtime.fault.PreemptionGuard`
  (SIGTERM) or ``stop()`` stops admission; in-flight slots finish.  The
  preemption drain (``cancel_queued=True``) also cancels the requests that
  were accepted but never reached a slot.

Synchronous use (deterministic; what the parity tests drive)::

    fe = ServingFrontend(lm, merged, n_slots=4, max_len=64)
    t = fe.submit(prompt, max_new_tokens=16, deadline_s=2.0)
    fe.run_until_drained()
    t.status, t.tokens, t.ttft

Threaded use (live traffic)::

    fe = ServingFrontend(...).start()
    tickets = [fe.submit(p, n) for p, n in feed]   # any thread
    fe.stop()                                      # drain + join

On the card the engine's steps are captured CUDA graphs; capture them
before live traffic (one pass through ``fe.engine`` and
``fe.engine.reset()``), since the serve thread would otherwise capture
while the caller's thread runs.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import Counter, deque
from typing import Callable, Dict, List, Optional

import numpy as np

from .engine import ContinuousEngine, EngineStats


class RequestStatus(enum.Enum):
    QUEUED = "QUEUED"        # accepted, waiting for a slot
    RUNNING = "RUNNING"      # occupies an engine slot
    FINISHED = "FINISHED"    # emitted EOS or max_new_tokens
    REJECTED = "REJECTED"    # never accepted (overload / invalid / drain)
    TIMED_OUT = "TIMED_OUT"  # TTFT or total deadline expired
    CANCELLED = "CANCELLED"  # cancel(rid), or queued at drain
    FAILED = "FAILED"        # engine unrecoverable (recovery cap hit)


TERMINAL_STATUSES = frozenset({
    RequestStatus.FINISHED, RequestStatus.REJECTED, RequestStatus.TIMED_OUT,
    RequestStatus.CANCELLED, RequestStatus.FAILED})


@dataclasses.dataclass(eq=False)  # identity equality: ndarray fields
class Ticket:
    """Lifecycle and result of one frontend request.

    ``tokens`` always holds the committed tokens (a failed engine step
    never commits, so they survive a recovery as they are); a terminal
    ticket that did not finish keeps its partial tokens.  Deadlines are
    seconds from ``t_submit``; the timing fields are frontend-clock stamps
    at dispatch granularity."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    src: Optional[np.ndarray] = None
    adapter_id: int = 0                      # resolved AdapterStore id
    deadline_s: Optional[float] = None       # total: submit -> last token
    ttft_deadline_s: Optional[float] = None  # submit -> first token
    seq: int = -1                            # arrival order (FIFO recovery)
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: str = ""
    n_recoveries: int = 0                    # engine resets while live
    t_submit: float = 0.0
    t_first: Optional[float] = None          # first committed token seen
    t_done: Optional[float] = None           # terminal transition
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    # tokens committed before the last engine reset (recovery submits
    # prompt + _base; the reset engine's stream appends after it)
    _base: List[int] = dataclasses.field(default_factory=list, repr=False)

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        if self.t_first is None or self.t_done is None or len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)


class ServingFrontend:
    """Live-intake, deadline-aware, fault-tolerant server around
    :class:`ContinuousEngine` (see the module docstring).

    The arguments are the reference's, plus the engine's ``eager``.
    ``cache_dtype`` (None: the engine's default, f32) goes to the engine,
    and so does ``max_src`` (encdec's cross-cache capacity).
    ``clock`` is injectable (``time.monotonic`` by default), so deadline
    behaviour is deterministic under test.  Every engine and scheduler
    mutation happens on the thread that drives ``step()``; ``submit`` and
    ``cancel`` from other threads touch only the intake queue and flags.
    """

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 8, decode_burst: int = 8,
                 queue_cap: int = 64, max_recoveries: int = 8,
                 default_deadline_s: Optional[float] = None,
                 default_ttft_deadline_s: Optional[float] = None,
                 injector: Optional[Callable] = None,
                 guard=None, clock: Callable[[], float] = time.monotonic,
                 cache_dtype=None, max_src: int = 0, adapters=None,
                 page_size: int = 0, n_pages=None, speculate: int = 0,
                 drafter=None, eager: bool = False):
        kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
        self.engine = ContinuousEngine(
            lm, params, n_slots=n_slots, max_len=max_len,
            prefill_chunk=prefill_chunk, decode_burst=decode_burst,
            max_src=max_src, step_hook=injector, adapters=adapters,
            page_size=page_size, n_pages=n_pages, speculate=speculate,
            drafter=drafter, eager=eager, **kw)
        self.queue_cap = queue_cap
        self.max_recoveries = max_recoveries
        self.default_deadline_s = default_deadline_s
        self.default_ttft_deadline_s = default_ttft_deadline_s
        self.guard = guard
        self.tickets: Dict[int, Ticket] = {}
        self.n_recoveries = 0
        self.fault_log: List[tuple] = []     # (t, repr(exc)) per recovery
        self.fatal: Optional[BaseException] = None
        self._clock = clock
        self._lock = threading.RLock()
        self._intake: deque = deque()        # tickets accepted, not planned
        self._cancels: set = set()           # rids with a pending cancel
        self._done_harvested: set = set()    # rids seen in sched.outputs
        self._next_rid = 0
        self._seq = 0
        self._draining = False
        self._drain_cancel = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._work_evt = threading.Event()
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        # engine stats survive resets: accumulated at each recovery
        self._stats_base = EngineStats()

    # ---------------- client API (any thread) ----------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: Optional[int] = None, rid: Optional[int] = None,
               src=None, deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               adapter_id=None) -> Ticket:
        """Queue a request; returns its :class:`Ticket` at once.

        Never raises for load or for the request's shape: the ticket comes
        back ``REJECTED`` with the reason (the queue depth for overload,
        an unknown ``adapter_id``, ...) in ``.error``.  ``adapter_id`` (an
        AdapterStore name or id; 0/None = the bare base) is resolved here,
        at submit time, so a later re-register cannot rebind an accepted
        request.  Only API misuse (a duplicate pinned ``rid``) raises."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = self._clock()
        with self._lock:
            if rid is None:
                rid = self._next_rid
            elif rid in self.tickets:
                raise ValueError(f"duplicate rid {rid}")
            self._next_rid = max(self._next_rid, rid + 1)
            t = Ticket(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                       eos_id=eos_id, src=src, seq=self._seq,
                       deadline_s=(self.default_deadline_s
                                   if deadline_s is None else deadline_s),
                       ttft_deadline_s=(self.default_ttft_deadline_s
                                        if ttft_deadline_s is None
                                        else ttft_deadline_s),
                       t_submit=now)
            self._seq += 1
            self.tickets[rid] = t
            err = self._admission_error(t, adapter_id)
            if err:
                self._finish(t, RequestStatus.REJECTED, error=err, now=now)
            else:
                self._intake.append(t)
        self._work_evt.set()
        return t

    def _admission_error(self, t: Ticket, adapter_id=None) -> str:
        """Why a fresh ticket is rejected, or '' (lock held).  On success
        the ticket's ``adapter_id`` holds the resolved store id."""
        if self.fatal is not None:
            return f"frontend failed: {self.fatal!r}"
        if self._draining:
            return "draining: not accepting new requests"
        depth = len(self._intake) + self.engine.sched.queue_depth
        if depth >= self.queue_cap:
            return (f"backpressure: queue full at depth {depth}/"
                    f"{self.queue_cap} (retry later or raise --queue-cap)")
        if adapter_id not in (None, 0):
            store = self.engine.adapters
            if store is None:
                return (f"request names adapter {adapter_id!r} but the "
                        f"engine has no AdapterStore")
            try:
                t.adapter_id = store.resolve(adapter_id)
                store.touch(t.adapter_id)
            except ValueError as e:
                return str(e)
        if len(t.prompt) < 1:
            return "empty prompt: feed BOS explicitly"
        if t.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        if len(t.prompt) + t.max_new_tokens > self.engine.max_len:
            return (f"request needs {len(t.prompt)} + {t.max_new_tokens} "
                    f"cache positions but slots hold {self.engine.max_len}")
        return ""

    def cancel(self, rid: int) -> bool:
        """Ask for a queued or in-flight request to be cancelled.  True iff
        the ticket was still live (the CANCELLED transition lands at the
        serve loop's next iteration)."""
        with self._lock:
            t = self.tickets[rid]
            if t.status in TERMINAL_STATUSES:
                return False
            self._cancels.add(rid)
        self._work_evt.set()
        return True

    def result(self, rid: int, timeout: Optional[float] = None) -> Ticket:
        """Block until the ticket is terminal (or ``timeout``); returns
        it."""
        t = self.tickets[rid]
        t.done.wait(timeout)
        return t

    def status_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(Counter(t.status.name for t in self.tickets.values()))

    @property
    def wall_s(self) -> float:
        if self._t0 is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t0

    @property
    def engine_stats(self) -> EngineStats:
        """Engine counters summed across fault-recovery resets."""
        return _sum_stats(self._stats_base, self.engine.stats)

    # ---------------- serve loop ----------------

    def start(self) -> "ServingFrontend":
        """Start the serve thread (live intake).  ``stop()`` drains it."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def _serve_loop(self):
        while True:
            busy = self.step()
            if self._stopped and not busy:
                return
            if not busy:
                self._work_evt.wait(0.002)
                self._work_evt.clear()

    def stop(self, *, cancel_queued: bool = False,
             timeout: float = 120.0) -> Dict[str, int]:
        """Graceful drain: stop admission, finish in-flight slots (and the
        accepted queue, unless ``cancel_queued``: the preemption drain,
        which cancels requests that never reached a slot).  Joins the
        serve thread if one runs; returns the per-status counts."""
        with self._lock:
            self._draining = True
            self._drain_cancel = self._drain_cancel or cancel_queued
            self._stopped = True
        self._work_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        else:
            self.run_until_drained()
        return self.status_counts()

    def run_until_drained(self) -> Dict[str, int]:
        """Drive ``step()`` on the calling thread until no work remains."""
        while self.step():
            pass
        return self.status_counts()

    def step(self) -> bool:
        """One frontend iteration: drain, cancel and deadline bookkeeping,
        then one engine dispatch (with fault recovery).  Returns True while
        work remains.  One caller only: call it directly or through
        ``start()``, never both."""
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        if (self.guard is not None and self.guard.requested
                and not self._draining):
            # SIGTERM: stop admission, cancel the undispatched queue,
            # finish the in-flight slots
            with self._lock:
                self._draining = True
                self._drain_cancel = True
        if self._drain_cancel:
            self._apply_drain_cancel()
        self._process_cancels()
        self._enforce_deadlines(now)
        self._admit_intake()
        worked = False
        if self.fatal is None and self.engine.sched.has_work:
            try:
                self.engine.step_once()
            except Exception as e:  # InjectedFault, EngineCorrupted, bugs
                self._recover(e)
            else:
                self._harvest(self._clock())
            worked = True
        self._t_last = self._clock()
        with self._lock:
            more = bool(self._intake) or bool(self._cancels)
        return worked or more or self.engine.sched.has_work

    # ---------------- iteration pieces (serve-loop thread) ----------------

    def _finish(self, t: Ticket, status: RequestStatus, *, error: str = "",
                now: Optional[float] = None):
        if t.status in TERMINAL_STATUSES:
            return
        t.status = status
        t.error = error
        t.t_done = self._clock() if now is None else now
        t.done.set()

    def _apply_drain_cancel(self):
        """Preemption drain: whatever was accepted but is not in a slot yet
        is cancelled; in-flight slots run to completion."""
        with self._lock:
            pending = list(self._intake)
            self._intake.clear()
        sched = self.engine.sched
        while sched.queue:
            pending.append(self.tickets[sched.queue.popleft().rid])
        for t in pending:
            self._finish(t, RequestStatus.CANCELLED,
                         error="drained before admission (preemption)")

    def _process_cancels(self):
        with self._lock:
            rids = list(self._cancels)
            self._cancels.clear()
        sched = self.engine.sched
        for rid in rids:
            t = self.tickets[rid]
            if t.status in TERMINAL_STATUSES:
                continue
            with self._lock:
                if t in self._intake:
                    self._intake.remove(t)
                    self._finish(t, RequestStatus.CANCELLED,
                                 error="cancelled while queued")
                    continue
            if sched.remove_queued(rid):
                self._finish(t, RequestStatus.CANCELLED,
                             error="cancelled while queued")
                continue
            for i, s in enumerate(sched.slots):
                if s is not None and s.req.rid == rid:
                    # the engine's eviction releases the pages and
                    # republishes the live adapter ids with the slot
                    self.engine.evict_slot(i)
                    t.tokens = t._base + s.emitted
                    self._finish(t, RequestStatus.CANCELLED,
                                 error=f"cancelled in flight after "
                                       f"{len(t.tokens)} tokens")
                    break

    def _expiry(self, t: Ticket, now: float) -> Optional[str]:
        age = now - t.t_submit
        if t.deadline_s is not None and age > t.deadline_s:
            return f"total deadline {t.deadline_s}s exceeded ({age:.3f}s)"
        if (t.t_first is None and t.ttft_deadline_s is not None
                and age > t.ttft_deadline_s):
            return f"TTFT deadline {t.ttft_deadline_s}s exceeded ({age:.3f}s)"
        return None

    def _enforce_deadlines(self, now: float):
        """Plan-time deadline check: an expired queued ticket never reaches
        a slot; an expired in-flight slot is evicted as an EOS slot is."""
        sched = self.engine.sched
        with self._lock:
            for t in [t for t in self._intake if self._expiry(t, now)]:
                self._intake.remove(t)
                self._finish(t, RequestStatus.TIMED_OUT,
                             error=self._expiry(t, now) + " while queued",
                             now=now)
        for r in list(sched.queue):
            t = self.tickets[r.rid]
            why = self._expiry(t, now)
            if why:
                sched.remove_queued(r.rid)
                self._finish(t, RequestStatus.TIMED_OUT,
                             error=why + " while queued", now=now)
        for i, s in enumerate(sched.slots):
            if s is None:
                continue
            t = self.tickets[s.req.rid]
            why = self._expiry(t, now)
            if why:
                self.engine.evict_slot(i)
                t.tokens = t._base + s.emitted
                self._finish(t, RequestStatus.TIMED_OUT,
                             error=f"{why}; emitted {len(t.tokens)}/"
                                   f"{t.max_new_tokens}", now=now)

    def _admit_intake(self):
        with self._lock:
            batch = []
            while self._intake:
                batch.append(self._intake.popleft())
        for t in batch:
            if t.status in TERMINAL_STATUSES:
                continue
            try:
                self.engine.submit(t.prompt, t.max_new_tokens,
                                   eos_id=t.eos_id, rid=t.rid, src=t.src,
                                   adapter_id=t.adapter_id)
            except (ValueError, NotImplementedError) as e:
                # the engine's own checks (a request the page pool can
                # never cover, an adapter evicted since submit, encoder
                # frames the engine cannot take)
                self._finish(t, RequestStatus.REJECTED, error=str(e))

    def _harvest(self, now: float):
        """Fold the committed engine state into the tickets: RUNNING
        transitions, first-token stamps, FINISHED outputs."""
        sched = self.engine.sched
        with self._lock:
            for s in sched.slots:
                if s is None:
                    continue
                t = self.tickets[s.req.rid]
                if t.status is RequestStatus.QUEUED:
                    t.status = RequestStatus.RUNNING
                if s.emitted:
                    t.tokens = t._base + s.emitted
                    if t.t_first is None:
                        t.t_first = now
            for rid, toks in sched.outputs.items():
                if rid in self._done_harvested:
                    continue
                self._done_harvested.add(rid)
                t = self.tickets[rid]
                t.tokens = t._base + toks
                if t.t_first is None:
                    t.t_first = now
                self._finish(t, RequestStatus.FINISHED, now=now)

    # ---------------- fault recovery ----------------

    def _recover(self, exc: BaseException):
        """Reset the engine after a failed step and submit every live
        request again as prompt + emitted (token for token the unfaulted
        stream under greedy decode: the failed step never committed)."""
        now = self._clock()
        self.n_recoveries += 1
        self.fault_log.append((now, repr(exc)))
        self._harvest(now)  # outputs finished BEFORE the failure are real
        sched = self.engine.sched
        if self.n_recoveries > self.max_recoveries:
            with self._lock:
                # set under the lock: submit() reads `fatal` while holding
                # it, and must never admit into a dying engine
                self.fatal = exc
                self.engine.reset()  # drop poisoned state + pending work
                for t in self.tickets.values():
                    self._finish(t, RequestStatus.FAILED,
                                 error=f"engine unrecoverable after "
                                       f"{self.max_recoveries} recoveries: "
                                       f"{exc!r}", now=now)
            return
        live = sorted((s for s in sched.slots if s is not None),
                      key=lambda s: self.tickets[s.req.rid].seq)
        queued = list(sched.queue)
        with self._lock:
            self._stats_base = _sum_stats(self._stats_base, self.engine.stats)
            self.engine.reset()
            self._done_harvested.clear()
            for s in live:  # in-flight first: they were admitted earliest
                t = self.tickets[s.req.rid]
                t.tokens = t._base + s.emitted
                t._base = list(t.tokens)
                t.n_recoveries += 1
                remaining = t.max_new_tokens - len(t.tokens)
                if remaining <= 0:  # defensive; commit would have finished
                    self._finish(t, RequestStatus.FINISHED, now=now)
                    continue
                prompt = np.concatenate(
                    [t.prompt, np.asarray(t.tokens, np.int32)])
                self.engine.submit(prompt, remaining, eos_id=t.eos_id,
                                   rid=t.rid, src=t.src,
                                   adapter_id=t.adapter_id)
            for r in queued:
                self.engine.submit(r.prompt, r.max_new_tokens,
                                   eos_id=r.eos_id, rid=r.rid, src=r.src,
                                   adapter_id=r.adapter_id)


def _sum_stats(a: EngineStats, b: EngineStats) -> EngineStats:
    """Field by field: every counter of :class:`EngineStats` survives a
    reset, the ragged ones the reference's engine lacks included."""
    return EngineStats(**{f.name: getattr(a, f.name) + getattr(b, f.name)
                          for f in dataclasses.fields(EngineStats)})


def slo_summary(frontend: ServingFrontend) -> Dict[str, float]:
    """Latency-SLO rollup of one frontend run: TTFT and TPOT percentiles
    over FINISHED requests (seconds), terminal-status rates over all
    tickets, and goodput (tokens of finished requests per wall second)."""
    tickets = list(frontend.tickets.values())
    counts = Counter(t.status.name for t in tickets)
    fins = [t for t in tickets if t.status is RequestStatus.FINISHED]
    ttfts = [t.ttft for t in fins if t.ttft is not None]
    tpots = [t.tpot for t in fins if t.tpot is not None]

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    n = max(len(tickets), 1)
    wall = max(frontend.wall_s, 1e-9)
    return {
        "n_requests": len(tickets),
        "finished": counts.get("FINISHED", 0),
        "ttft_p50_s": pct(ttfts, 50), "ttft_p95_s": pct(ttfts, 95),
        "ttft_p99_s": pct(ttfts, 99),
        "tpot_p50_s": pct(tpots, 50), "tpot_p95_s": pct(tpots, 95),
        "tpot_p99_s": pct(tpots, 99),
        "timeout_rate": counts.get("TIMED_OUT", 0) / n,
        "reject_rate": counts.get("REJECTED", 0) / n,
        "goodput_tok_s": sum(len(t.tokens) for t in fins) / wall,
        "recoveries": frontend.n_recoveries,
    }
