"""Continuous-batching serving engine over the ragged step (counterpart of
``repro.serving.engine`` for the gqa family, contiguous KV cache, no
speculation).

The engine drives :meth:`repro_torch.models.lm.LM.step_ragged` — one
step in which every cache slot advances by its own number of tokens —
with the host-side :class:`~repro_torch.serving.scheduler.Scheduler`
deciding what each slot consumes:

  * admission: queued requests enter free slots mid-flight; the slot's
    length is reset to 0 and its stale KV is never read;
  * chunked prefill: prompts stream in ``prefill_chunk``-token chunks
    while decode slots ride along in the same batch;
  * per-request termination: slots stop at EOS or ``max_new_tokens`` and
    are evicted and refilled;
  * decode bursts: when every active slot is decoding, ``decode_burst``
    single-token steps run back to back with per-slot stop masks kept on
    the device, and the host reads the burst's tokens once at its end
    (the reference's ``lax.scan``).

Multi-tenant serving: with an :class:`~repro_torch.serving.AdapterStore`
the served tree is the store's ``with_slot_ids`` tree for the current
slot -> adapter mapping, rebuilt only when the mapping or the store
changes; decode steps then run the slot GEMV kernel.

Compiled steps: on CUDA the ragged step (at its fixed chunk width) and
the burst (at each k of the pow2 ladder {1, 2, .., ``decode_burst``})
replay CUDA graphs (:class:`~repro_torch.runtime.graphs.StepGraphs`, one
memory pool for both), the counterpart of the reference's module-level
jits.  Their inputs are staged into static buffers through pinned host
memory, the decode cache and the slot -> adapter ids stay at fixed
addresses, and the captures are budgeted as the reference budgets its
compiles (:mod:`repro_torch.runtime.compile_guard`, checked after every
iteration).  ``eager=True`` runs the same steps op by op (the oracle runs);
it is never chosen implicitly.  On the CPU the steps run eagerly.  The
paged cache, speculative decoding, encdec sources and the other families
raise.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.runtime import compile_guard
from repro_torch.runtime.graphs import StepGraphs, captures
from .scheduler import Request, Scheduler


def _ragged_step(lm, params, cache, tokens, n_new):
    """One ragged step, advancing the cache in place; argmax and the
    health bit (all logits finite) stay on the device."""
    logits, _ = lm.step_ragged(params, cache, tokens, n_new)
    ok = torch.isfinite(logits).all()
    return logits.argmax(-1).to(torch.int32), ok


def _burst_steps(lm, params, cache, tok, remaining, eos, k_steps: int):
    """``k_steps`` masked single-token ragged steps on the cache, in place.
    A slot whose remaining count hits 0 (max-len or EOS) stops consuming
    (n_new=0), so its cache and length freeze until the host evicts it.
    Stop masks, argmax and counts stay on the device: nothing here waits
    for the card.  Returns (tok, remaining, emitted [k, B], ok)."""
    emitted, oks = [], []
    for _ in range(k_steps):
        active = remaining > 0
        logits, _ = lm.step_ragged(params, cache, tok[:, None],
                                   active.to(torch.int32))
        nxt = torch.where(active, logits.argmax(-1).to(torch.int32), tok)
        emitted.append(torch.where(active, nxt, -1))
        stop = active & ((remaining <= 1) | (nxt == eos))
        remaining = torch.where(stop, 0,
                                torch.where(active, remaining - 1, 0))
        oks.append(torch.isfinite(logits).all())
        tok = nxt
    return tok, remaining, torch.stack(emitted), torch.stack(oks).all()


def _to_host(*tensors) -> List[np.ndarray]:
    """One device-to-host copy for several int32 tensors."""
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


class EngineCorrupted(RuntimeError):
    """The health bit tripped: a step produced non-finite logits
    (corrupted decode state).  Raised BEFORE the step's tokens commit; the
    engine's device state must be considered poisoned (``reset()``)."""


@dataclasses.dataclass
class EngineStats:
    """Aggregates :meth:`ContinuousEngine.step_once` iterations.

    ``slot_steps`` / ``busy_slot_steps`` count model rows: each dispatch
    that runs C rows per slot adds ``n_slots * C`` to ``slot_steps`` and
    the rows actually consumed to ``busy_slot_steps``, so ``occupancy`` is
    the fraction of computed rows that did useful work.  Ragged dispatches
    always run C = ``prefill_chunk`` (a step with no prompt left to feed
    is a burst), so the C = 1 decode rows are ``model_steps -
    prefill_chunk * ragged_dispatches``; ``ragged_seconds`` is the wall
    time of the ragged iterations, the rest of ``seconds`` that of the
    bursts."""

    model_steps: int = 0        # model rows computed per slot (C per dispatch)
    dispatches: int = 0         # ragged steps + bursts
    ragged_dispatches: int = 0  # of those, ragged steps
    tokens_out: int = 0         # useful generated tokens
    slot_steps: int = 0         # slots x model rows computed
    busy_slot_steps: int = 0    # of those, rows a slot actually consumed
    seconds: float = 0.0
    ragged_seconds: float = 0.0

    @property
    def occupancy(self) -> float:
        return self.busy_slot_steps / max(self.slot_steps, 1)

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / max(self.seconds, 1e-9)


class ContinuousEngine:
    """Serve an LM with in-flight batching over a slotted KV cache.

    ``n_slots`` concurrent requests share one decode cache of per-slot
    capacity ``max_len`` (each request needs prompt + max_new <=
    max_len), on the device of ``params``.  ``decode_burst`` is clamped
    down to a power of two, as in the reference.  ``eager=True`` runs
    every step op by op instead of replaying its CUDA graph."""

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 8, decode_burst: int = 8,
                 max_src: int = 0, adapters=None, page_size: int = 0,
                 n_pages: Optional[int] = None, speculate: int = 0,
                 drafter=None, eager: bool = False):
        not_ported = {"page_size": page_size > 0, "n_pages": n_pages,
                      "speculate": speculate, "drafter": drafter,
                      "max_src": max_src}
        for name, val in not_ported.items():
            if val:
                raise NotImplementedError(
                    f"ContinuousEngine({name}=...): not yet ported (see "
                    f"ROADMAP.md); the port serves gqa, contiguous cache, "
                    f"speculate=0")
        self.lm, self.params = lm, params
        self.n_slots, self.max_len = n_slots, max_len
        # multi-tenant serving: the store supplies the served tree (shared
        # INT-N base + per-slot adapter ids); `params` is then its base
        self.adapters = adapters
        self._adapter_key = None
        self.prefill_chunk = prefill_chunk
        db = max(1, decode_burst)
        self.decode_burst = 1 << (db.bit_length() - 1)
        self.device = params.embed.device
        self.slot_state = lm.slot_state()
        ragged = StepGraphs("engine.ragged", self.device, eager=eager)
        self.graphs = {"ragged": ragged,
                       "burst": StepGraphs("engine.burst", self.device,
                                           eager=eager, pool=ragged.pool)}
        # captures each step may make: one chunk width for the ragged step
        # (one placement on one card), the pow2 ladder for the burst
        self.budgets = {"engine.ragged": 1,
                        "engine.burst": self.decode_burst.bit_length()}
        # the served tree's slot -> adapter ids, at a fixed address
        self._slot_ids = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=self.device)
        self.cache = self.slot_state.init(n_slots, max_len,
                                          dtype=torch.float32,
                                          device=self.device)
        self.reset()
        self._declare_budgets()

    def _declare_budgets(self):
        """Declare the steps' capture budgets to the active compile guard,
        as the reference's engine declares its jits' (per-engine owner,
        reclaimed when the engine is collected).  The eager and CPU routes
        capture nothing and declare nothing."""
        g = compile_guard.current()
        if g is None or self.graphs["ragged"].capture is None:
            return
        owner = f"engine-{id(self)}"
        weakref.finalize(self, g.release_owner, owner)
        for name, budget in self.budgets.items():
            g.declare_jit(name, captures(name), budget, owner=owner)

    def reset(self):
        """Drop all queued and in-flight state.  The decode cache is
        cleared in place: the captured steps keep their addresses."""
        self.sched = Scheduler(self.n_slots, self.max_len, self.prefill_chunk)
        self.slot_state.clear(self.cache)
        self.stats = EngineStats()
        self._adapter_key = None
        self._refresh_adapters()

    # ---------------- public API ----------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None, rid: Optional[int] = None,
               src=None, adapter_id=None) -> int:
        """Queue a request; returns its rid (key into run()'s results).
        ``adapter_id`` (name or id of a registered adapter; 0/None = null
        adapter) binds the request to one tenant; unknown ids raise here,
        not mid-serve."""
        if src is not None:
            raise NotImplementedError("encdec src frames: not yet ported "
                                      "(see ROADMAP.md)")
        aid = 0
        if adapter_id not in (None, 0):
            if self.adapters is None:
                raise ValueError(
                    f"request names adapter {adapter_id!r} but the engine "
                    f"has no AdapterStore (pass adapters= at construction)")
            aid = self.adapters.resolve(adapter_id)  # ValueError on unknown
            self.adapters.touch(aid)
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      rid=-1 if rid is None else rid, adapter_id=aid)
        return self.sched.submit(req)

    def run(self) -> Dict[int, List[int]]:
        """Serve until queue and slots drain; returns rid -> token list."""
        while self.sched.has_work:
            self.step_once()
        # republish the (now empty) live-id set, so the store may evict
        # the last batch's adapters
        self._refresh_adapters()
        return self.sched.outputs

    def evict_slot(self, i: int):
        """Evict slot ``i`` (cancellation) and republish the live-adapter
        set in the same call.  Returns the evicted Slot (or None)."""
        s = self.sched.evict_slot(i)
        self._refresh_adapters()
        return s

    def poison_cache(self):
        """Overwrite every floating-point leaf of the decode state with NaN,
        in place (fault injection): a slot whose state is read next produces
        NaN logits and trips :class:`EngineCorrupted` before commit."""
        for t in self.cache["layers"].values():
            t.fill_(float("nan"))

    # ---------------- one engine iteration ----------------

    def step_once(self):
        """One iteration: admit + reset refilled slots ->
        one ragged step or burst -> commit.  Raises
        :class:`EngineCorrupted` (before commit) on non-finite logits.
        Wall clock accrues to :attr:`stats` here."""
        t0 = time.perf_counter()
        ragged = False
        try:
            ragged = self._step_once_inner()
        finally:
            dt = time.perf_counter() - t0
            self.stats.seconds += dt
            if ragged:
                self.stats.ragged_seconds += dt
        guard = compile_guard.current()
        if guard is not None:
            # after the step, not inside the finally: a budget violation
            # must not mask a real dispatch failure mid-step
            guard.check()

    def _step_once_inner(self) -> bool:
        filled = self.sched.admit()
        if filled:
            mask = np.zeros((self.n_slots,), bool)
            mask[filled] = True
            self.slot_state.reset(self.cache,
                                  torch.as_tensor(mask, device=self.device))
        self._refresh_adapters()
        if self.sched.all_decoding:
            self._run_burst()
            return False
        self._run_ragged()
        return True

    def _refresh_adapters(self):
        """Rebind ``self.params`` to the store's serving tree for the
        current slot -> adapter mapping (only when the mapping or the
        store changed; the ids go into the engine's static buffer, and the
        store writes its banks in place, so the captured steps stay valid),
        and publish the live-id set so the store never evicts an adapter a
        queued or in-flight request needs."""
        if self.adapters is None:
            return
        self.adapters.set_live(self.sched.live_adapter_ids())
        ids = self.sched.slot_adapter_ids()
        key = (tuple(ids.tolist()), self.adapters.version)
        if key != self._adapter_key:
            self._adapter_key = key
            self.params = self.adapters.with_slot_ids(ids,
                                                      out=self._slot_ids)

    def _run_ragged(self):
        """One mixed prefill/decode ragged step."""
        tokens, n_new = self.sched.plan()
        graphs, key = self.graphs["ragged"], ("ragged",) + tokens.shape
        buf = graphs.stage(key, tokens=tokens, n_new=n_new)
        nxt, ok = graphs(key, lambda: _ragged_step(
            self.lm, self.params, self.cache, buf["tokens"], buf["n_new"]))
        nxt, ok = _to_host(nxt, ok)
        if not ok:
            raise EngineCorrupted("non-finite logits in ragged step (decode "
                                  "state is poisoned); tokens NOT committed")
        # slots past their prompt after this plan emit one token each;
        # mid-prompt slots consume rows but emit nothing yet
        emitting = sum(1 for i, s in enumerate(self.sched.slots)
                       if s is not None and n_new[i] > 0 and not s.prefilling)
        self.sched.commit(nxt)
        st = self.stats
        c = int(tokens.shape[1])
        st.dispatches += 1
        st.ragged_dispatches += 1
        st.model_steps += c
        st.slot_steps += self.n_slots * c
        st.busy_slot_steps += int(n_new.sum())
        st.tokens_out += emitting

    def _run_burst(self):
        """K decode steps with per-slot stop masks; one host copy at the
        end."""
        tok, remaining, eos = self.sched.burst_state()
        # follow the SHORTEST active request, rounded down to a power of
        # two, so finished slots are evicted and refilled promptly
        k_min = int(remaining[remaining > 0].min())
        k = int(min(self.decode_burst, 1 << (k_min.bit_length() - 1)))
        graphs, key = self.graphs["burst"], ("burst", k)
        buf = graphs.stage(key, tok=tok, remaining=remaining, eos=eos)
        tok_d, rem_d, emitted, ok = graphs(key, lambda: _burst_steps(
            self.lm, self.params, self.cache, buf["tok"], buf["remaining"],
            buf["eos"], k_steps=k))
        emitted, tok_d, rem_d, ok = _to_host(emitted, tok_d, rem_d, ok)
        if not ok:
            raise EngineCorrupted("non-finite logits in decode burst (decode "
                                  "state is poisoned); tokens NOT committed")
        self.sched.commit_burst(emitted, tok_d, rem_d)
        st = self.stats
        st.dispatches += 1
        st.model_steps += k
        st.slot_steps += self.n_slots * k
        st.busy_slot_steps += int((emitted >= 0).sum())
        st.tokens_out += int((emitted >= 0).sum())
