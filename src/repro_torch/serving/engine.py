"""Continuous-batching serving engine over the ragged step (counterpart of
``repro.serving.engine`` for the gqa and gqa_moe families).

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

Paged KV cache: with ``page_size > 0`` the cache's K/V are pools of pages
shared by every slot (:mod:`repro_torch.serving.paging`); admission takes
exactly the pages a request needs and backs off when the pool is dry, and
a prompt whose leading full pages another request (of the same adapter)
already wrote maps those pages and skips their prefill.  Speculative
decoding: with ``speculate=k`` and a drafter (a reduced-bits copy of the
served model, :func:`make_self_drafter`), each decode dispatch drafts k
tokens a slot in k+1 single-token steps of the drafter, verifies all k+1
positions in one ragged step of the target
(:meth:`repro_torch.models.lm.LM.verify_ragged`) and commits each slot's
accepted prefix plus one (:mod:`repro_torch.serving.speculative`): the
streams are those of plain greedy decode.  The drafter keeps a cache of
its own, in lockstep with the target's (it rides along every ragged step;
paged, it mirrors the target's page rows).

Multi-tenant serving: with an :class:`~repro_torch.serving.AdapterStore`
the served tree is the store's ``with_slot_ids`` tree for the current
slot -> adapter mapping, rebuilt only when the mapping or the store
changes; decode steps then run the slot GEMV kernel.

Compiled steps: on CUDA the ragged step (at its fixed chunk width; the
drafter's ride-along is a second capture), the burst (at each k of the
pow2 ladder {1, 2, .., ``decode_burst``}), the draft steps and the verify
step replay CUDA graphs (:class:`~repro_torch.runtime.graphs.StepGraphs`,
one memory pool for all), the counterpart of the reference's module-level
jits.  Their inputs are staged into static buffers through pinned host
memory; the caches (page rows and lengths included: admission, eviction
and rollback write them in place), and the slot -> adapter ids stay at
fixed addresses; the captures are budgeted as the reference budgets its
compiles (:mod:`repro_torch.runtime.compile_guard`, checked after every
iteration).  ``eager=True`` runs the same steps op by op (the oracle
runs); it is never chosen implicitly.  On the CPU the steps run eagerly.
Encdec sources, the MTP drafter and the other families raise, and so do
tenants over a gqa_moe model (:data:`MOE_TENANTS`).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import schemes
from repro_torch.runtime import compile_guard
from repro_torch.runtime.graphs import StepGraphs, captures
from .paging import PageTable, pages_for
from .scheduler import Request, Scheduler
from .speculative import accept_drafts, rollback_counts


# what the engine and the serve CLI say to tenants over a gqa_moe model
MOE_TENANTS = (
    "a gqa_moe model serves no tenants: an expert's linears run on its "
    "[C, d] capacity buffer, whose rows carry no slot id, so a per-slot "
    "adapter cannot be picked there; the JAX package's slot scheme has no "
    "per-row ids inside a capacity buffer either (its bank delta gets the "
    "buffer and the [B] slot ids and raises), so there is no reference to "
    "port (ROADMAP.md, faults of the reference)")


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


def _draft_steps(lm, params, cache, tok, active, k_steps: int):
    """The drafter's ``k_steps`` single-token steps on its cache, in place
    (active slots consume one row each, idle ones none).  Step i inserts
    its input token and argmaxes the next draft, so the steps propose
    d_1..d_{k_steps-1} and leave the drafter's cache holding the rows the
    verify step writes on the target's (t0, d_1, ..): the last step's
    output is discarded, and the rollback after acceptance is then the
    same for both caches.  No health check: a bad draft is rejected by
    verification.  Returns the drafts [k_steps, B]."""
    n = active.to(torch.int32)
    drafts = []
    for _ in range(k_steps):
        logits, _ = lm.step_ragged(params, cache, tok[:, None], n)
        tok = torch.where(active, logits.argmax(-1).to(torch.int32), tok)
        drafts.append(tok)
    return torch.stack(drafts)


def _verify_step(lm, params, cache, tokens, n_new):
    """All k+1 speculative positions in ONE ragged step: the per-position
    argmax [B, C] (column i is the target's next token after
    ``tokens[:, :i+1]``) and the health bit over the consumed rows only
    (rows past ``n_new`` are garbage).  The cache advances by the full
    ``n_new``; the host rolls the rejected tail back."""
    logits, _ = lm.verify_ragged(params, cache, tokens, n_new)
    valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
             < n_new[:, None])
    ok = torch.isfinite(torch.where(valid[..., None], logits, 0.0)).all()
    return logits.argmax(-1).to(torch.int32), ok


def make_self_drafter(params, policy: str, base=None):
    """A reduced-bits SELF-SPECULATION drafter from the served (merged)
    weights: every linear of ``params`` re-stored under the policy
    ``policy`` (e.g. ``"*=intq8"``: bare re-quantization of the dense view,
    no adapters; see :meth:`repro_torch.core.schemes.PolicyTree.parse`,
    ``base`` the policy the values refine).  No training: the drafter is
    the served model at another precision, so its argmax agrees with the
    target's wherever quantization noise does not flip the top logit.
    Returns a params tree for ``ContinuousEngine(..., speculate=k,
    drafter=<tree>)`` (the engine also takes the policy string and calls
    this)."""
    return schemes.convert_tree(params,
                                schemes.PolicyTree.parse(policy, base))


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
    is a burst or a speculative round), so the decode rows (C = 1 a burst
    step, C = k+1 a verify step) are ``model_steps - prefill_chunk *
    ragged_dispatches``; ``ragged_seconds`` is the wall time of the ragged
    iterations, the rest of ``seconds`` that of the bursts or rounds.

    Speculation: ``model_steps`` / ``slot_steps`` count TARGET rows only
    (the drafter's cost shows in ``seconds``), while ``dispatches`` counts
    every step run, the drafter's too (its ride-along ragged step, the
    draft steps of a round).  ``proposed_tokens`` are drafts offered to a
    verify step, ``accepted_tokens`` those that committed; a round's
    bonus or correction token is a plain greedy token, counted in
    ``tokens_out`` only."""

    model_steps: int = 0        # model rows computed per slot (C per dispatch)
    dispatches: int = 0         # steps run, the drafter's included
    ragged_dispatches: int = 0  # of those, the target's ragged steps
    tokens_out: int = 0         # useful generated tokens
    slot_steps: int = 0         # slots x model rows computed
    busy_slot_steps: int = 0    # of those, rows a slot actually consumed
    seconds: float = 0.0
    ragged_seconds: float = 0.0
    proposed_tokens: int = 0    # drafts offered to a verify step
    accepted_tokens: int = 0    # of those, committed (prefix-matched)

    @property
    def occupancy(self) -> float:
        return self.busy_slot_steps / max(self.slot_steps, 1)

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / max(self.seconds, 1e-9)

    @property
    def acceptance_rate(self) -> float:
        """Share of proposed drafts that committed (0.0 when none was
        proposed)."""
        return self.accepted_tokens / max(self.proposed_tokens, 1)


class ContinuousEngine:
    """Serve an LM with in-flight batching over a slotted KV cache.

    ``n_slots`` concurrent requests share one decode cache of per-slot
    capacity ``max_len`` (each request needs prompt + max_new (+
    ``speculate``) <= max_len), on the device of ``params``.
    ``decode_burst`` is clamped down to a power of two, as in the
    reference.  ``eager=True`` runs every step op by op instead of
    replaying its CUDA graph.

    ``page_size > 0`` switches the cache to the paged pools: ``n_pages``
    pages (page 0 the null page; by default the contiguous capacity,
    ``n_slots * ceil(max_len / page_size) + 1``; fewer oversubscribe the
    pool, and admission then backs off while it is dry).

    ``speculate = k > 0`` drafts k tokens a slot per decode dispatch; it
    needs ``decode_burst`` 1 and a ``drafter`` (a policy string such as
    ``"*=intq8"``, given to :func:`make_self_drafter` with the served
    tree, or a drafter tree), and refuses an ``AdapterStore``.

    ``step_hook(engine)`` is called once per :meth:`step_once`, before
    admission and the dispatch: it may sleep (straggler injection), poison
    the cache (:meth:`poison_cache`) or raise (crash injection), see
    :class:`repro_torch.runtime.fault.FaultInjector`.  It survives
    :meth:`reset`."""

    def __init__(self, lm, params, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 8, decode_burst: int = 8,
                 max_src: int = 0, step_hook=None, adapters=None,
                 page_size: int = 0, n_pages: Optional[int] = None,
                 speculate: int = 0, drafter=None, eager: bool = False):
        if max_src:
            raise NotImplementedError(
                "ContinuousEngine(max_src=...): encdec cross caches are not "
                "yet ported (see ROADMAP.md); the port serves gqa")
        if lm.cfg.family == "gqa_moe" and adapters is not None:
            raise NotImplementedError(MOE_TENANTS)
        self.lm, self.params = lm, params
        self.n_slots, self.max_len = n_slots, max_len
        self.step_hook = step_hook
        # multi-tenant serving: the store supplies the served tree (shared
        # INT-N base + per-slot adapter ids); `params` is then its base
        self.adapters = adapters
        self._adapter_key = None
        self.prefill_chunk = prefill_chunk
        db = max(1, decode_burst)
        self.decode_burst = 1 << (db.bit_length() - 1)
        self.device = params.embed.device
        self.speculate = int(speculate)
        self.draft_params = self._check_speculation(decode_burst, drafter)
        self.page_size = page_size
        if page_size > 0:
            if n_pages is None:
                n_pages = n_slots * pages_for(max_len, page_size) + 1
            self.n_pages = n_pages
            self.slot_state = lm.slot_state(page_size, n_pages)
        else:
            self.n_pages = 0
            self.slot_state = lm.slot_state()
        ragged = StepGraphs("engine.ragged", self.device, eager=eager)
        self.graphs = {"ragged": ragged}
        # a speculating engine decodes in rounds, never in bursts
        for name in (("draft", "verify") if self.speculate else ("burst",)):
            self.graphs[name] = StepGraphs(f"engine.{name}", self.device,
                                           eager=eager, pool=ragged.pool)
        # captures each step may make: one chunk width for the ragged step
        # (one placement on one card; the drafter's ride-along is a
        # second), the pow2 ladder for the burst, one draft scan and one
        # verify width
        if self.speculate:
            self.budgets = {"engine.ragged": 2, "engine.draft": 1,
                            "engine.verify": 1}
        else:
            self.budgets = {"engine.ragged": 1,
                            "engine.burst": self.decode_burst.bit_length()}
        # the served tree's slot -> adapter ids, at a fixed address
        self._slot_ids = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=self.device)
        self.cache = self.slot_state.init(n_slots, max_len,
                                          dtype=torch.float32,
                                          device=self.device)
        # the drafter's cache mirrors the target's (paged: a second pool
        # addressed by the same page rows), so its rows land at the same
        # positions and the rollback is one shared length subtraction
        self.draft_cache = None
        if self.draft_params is not None:
            self.draft_cache = self.slot_state.init(
                n_slots, max_len, dtype=torch.float32, device=self.device)
        self.reset()
        self._declare_budgets()

    def _check_speculation(self, decode_burst: int, drafter):
        """The reference's checks of the speculation knobs; returns the
        drafter tree (None when not speculating)."""
        k = self.speculate
        if k < 0:
            raise ValueError(f"speculate must be >= 0; got {k}")
        if k == 0:
            return None
        if self.decode_burst > 1:
            raise ValueError(
                f"speculate={k} and decode_burst={decode_burst} are both "
                f"multi-token decode paths and do not compose: a burst "
                f"commits every step while speculation commits accepted "
                f"prefixes with rollback.  Pass decode_burst=1 when "
                f"speculating (the verify step IS the multi-token "
                f"dispatch).")
        if not self.lm.slot_state().supports_rollback():
            raise NotImplementedError(
                f"speculative decoding needs rollback by length, which "
                f"family {self.lm.cfg.family!r} does not support")
        if self.adapters is not None:
            raise NotImplementedError(
                "speculative decoding with an AdapterStore would need the "
                "drafter rebuilt per slot->adapter remap; serve adapters "
                "with speculate=0")
        if drafter is None:
            raise ValueError(
                "speculate > 0 needs a drafter: a policy spec string (e.g. "
                "'*=intq8': a reduced-bits self-speculation view of the "
                "merged base, built by make_self_drafter) or a drafter "
                "params tree")
        if isinstance(drafter, str):
            if drafter == "mtp":
                raise NotImplementedError(
                    "drafter='mtp' needs the mla_moe family's MTP head, not "
                    "yet ported (see ROADMAP.md)")
            return make_self_drafter(self.params, drafter,
                                     base=self.lm.cfg.quant.default)
        return drafter

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
        """Drop all queued and in-flight state.  The caches are cleared in
        place (the captured steps keep their addresses); a paged engine
        starts a new page table (no registered prefix survives: its pages
        are zeroed)."""
        pt = None
        if self.page_size > 0:
            pt = PageTable(self.n_pages, self.page_size,
                           self.slot_state.slot_pages(self.max_len))
        self.sched = Scheduler(self.n_slots, self.max_len, self.prefill_chunk,
                               page_table=pt, headroom=self.speculate)
        for cache in self._caches():
            self.slot_state.clear(cache)
        self.stats = EngineStats()
        self._adapter_key = None
        self._refresh_adapters()

    def _caches(self):
        """The target's cache, and the drafter's when there is one."""
        return [c for c in (self.cache, self.draft_cache) if c is not None]

    @property
    def page_table(self) -> Optional[PageTable]:
        """The live page pool (None on contiguous engines)."""
        return self.sched.page_table

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
        """Evict slot ``i`` (cancellation): the scheduler frees the slot
        and releases its pages, and the live-adapter set is republished, in
        the same call.  Returns the evicted Slot (or None)."""
        s = self.sched.evict_slot(i)
        self._refresh_adapters()
        return s

    def poison_cache(self):
        """Overwrite every floating-point leaf of the decode state with NaN,
        in place (fault injection): the K/V rows of the contiguous cache,
        or the whole page pool of a paged one.  A slot whose state is read
        next produces NaN logits and trips :class:`EngineCorrupted` before
        commit; :meth:`reset` zeroes the rows again."""
        for t in self.cache["layers"].values():
            t.fill_(float("nan"))

    # ---------------- one engine iteration ----------------

    def step_once(self):
        """One iteration: (step hook ->) admit + reset refilled slots ->
        one ragged step, burst or speculative round -> commit.  Raises
        :class:`EngineCorrupted` (before commit) on non-finite logits, and
        whatever the step hook raises (before admission, so the streams
        stay as they were).  Wall clock accrues to :attr:`stats` here, the
        hook's included."""
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
        if self.step_hook is not None:
            self.step_hook(self)
        filled = self.sched.admit()
        if filled:
            mask = np.zeros((self.n_slots,), bool)
            mask[filled] = True
            mask = torch.as_tensor(mask, device=self.device)
            for cache in self._caches():
                self.slot_state.reset(cache, mask)
            self._publish_pages(filled)
        self._refresh_adapters()
        if self.sched.all_decoding:
            if self.speculate:
                self._run_spec()
            else:
                self._run_burst()
            return False
        self._run_ragged()
        return True

    def _publish_pages(self, filled):
        """Paged admission: write each refilled slot's page row, and seed
        its length with the prefix tokens served from shared pages, into
        the caches in place (after the refill's reset nulled the rows; the
        captured steps read them at their addresses).  The drafter's pool
        mirrors the page rows: a prefix hit holds for the drafter too,
        since it wrote its own pool at the same pages when the first
        request prefilled (its ride-along in :meth:`_run_ragged`)."""
        if self.page_size == 0:
            return
        pt = self.sched.page_table
        idx = torch.as_tensor(filled, dtype=torch.int64, device=self.device)
        rows = torch.as_tensor(np.stack([pt.page_row(i) for i in filled]),
                               device=self.device)
        lens = torch.as_tensor([self.sched.slots[i].pp for i in filled],
                               dtype=torch.int32, device=self.device)
        for cache in self._caches():
            cache["pages"].index_copy_(0, idx, rows)
            cache["len"].index_copy_(0, idx, lens)

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
        """One mixed prefill/decode ragged step (and the drafter's
        ride-along on the same plan)."""
        tokens, n_new = self.sched.plan()
        graphs, key = self.graphs["ragged"], ("ragged",) + tokens.shape
        buf = graphs.stage(key, tokens=tokens, n_new=n_new)
        nxt, ok = graphs(key, lambda: _ragged_step(
            self.lm, self.params, self.cache, buf["tokens"], buf["n_new"]))
        nxt, ok = _to_host(nxt, ok)
        st = self.stats
        if self.draft_cache is not None:
            # the drafter consumes the same plan so its cache rows stay in
            # lockstep with the target's; its tokens are discarded and its
            # health unchecked (verification rejects bad drafts).  Its own
            # capture: the graph holds the drafter's weights
            graphs(("ragged-draft",) + tokens.shape, lambda: _ragged_step(
                self.lm, self.draft_params, self.draft_cache, buf["tokens"],
                buf["n_new"]))
            st.dispatches += 1
        if not ok:
            raise EngineCorrupted("non-finite logits in ragged step (decode "
                                  "state is poisoned); tokens NOT committed")
        # slots past their prompt after this plan emit one token each;
        # mid-prompt slots consume rows but emit nothing yet
        emitting = sum(1 for i, s in enumerate(self.sched.slots)
                       if s is not None and n_new[i] > 0 and not s.prefilling)
        self.sched.commit(nxt)
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


    def _run_spec(self):
        """One draft-and-verify round (every slot decoding): the drafter
        proposes k tokens per active slot in k+1 single-token steps, the
        target verifies all k+1 positions in one ragged step, and each slot
        commits its accepted prefix plus the bonus or correction token
        (the stream is plain greedy decode's).  The verify step advanced
        every active slot by k+1 rows; the rejected tail rolls back by a
        per-slot length subtraction, in place, on both caches, restoring
        "the cache holds the committed stream minus its last token".

        On :class:`EngineCorrupted` the drafter's cache may have advanced
        already; the engine must be reset before serving on anyway."""
        tok, remaining, eos = self.sched.burst_state()
        active = remaining > 0
        k = self.speculate
        # each step reads its own staged buffers (a captured step's
        # closure must not see them rebound)
        draft, key = self.graphs["draft"], ("draft", k + 1)
        dbuf = draft.stage(key, tok=tok, active=active)
        d = draft(key, lambda: _draft_steps(
            self.lm, self.draft_params, self.draft_cache, dbuf["tok"],
            dbuf["active"], k_steps=k + 1))
        (d,) = _to_host(d)
        drafts = d[:k].T                       # [B, k] = d_1..d_k
        tokens = np.concatenate([tok[:, None], drafts], axis=1)
        n_new = np.where(active, k + 1, 0).astype(np.int32)
        verify, key = self.graphs["verify"], ("verify",) + tokens.shape
        vbuf = verify.stage(key, tokens=tokens, n_new=n_new)
        v, ok = verify(key, lambda: _verify_step(
            self.lm, self.params, self.cache, vbuf["tokens"], vbuf["n_new"]))
        v, ok = _to_host(v, ok)
        if not ok:
            raise EngineCorrupted("non-finite logits in speculative verify "
                                  "(decode state is poisoned); tokens NOT "
                                  "committed")
        emitted, m = accept_drafts(drafts, v, n_new, remaining, eos)
        rb = torch.as_tensor(rollback_counts(n_new, m).astype(np.int32),
                             device=self.device)
        for cache in self._caches():
            cache["len"].sub_(rb)
        self.sched.commit_spec(emitted, m)
        st = self.stats
        st.dispatches += 2
        st.model_steps += k + 1
        st.slot_steps += self.n_slots * (k + 1)
        st.busy_slot_steps += int(n_new.sum())
        st.tokens_out += int(m.sum())
        st.proposed_tokens += k * int(active.sum())
        st.accepted_tokens += int(np.maximum(m - 1, 0).sum())
