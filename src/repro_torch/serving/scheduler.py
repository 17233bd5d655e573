"""Slot scheduler for the continuous-batching engine (counterpart of
``repro.serving.scheduler``).

Pure host-side bookkeeping in numpy (neither torch nor jax), so slot
lifecycle (queued -> prefill -> decode -> finished, eviction + refill) is
unit testable without a model.

A ``Slot`` owns one row of the engine's slotted KV cache.  The scheduler
admits queued requests into free slots mid-flight (FIFO), plans each
ragged step (``tokens [B, C]`` / ``n_new [B]`` for
:meth:`repro_torch.models.lm.LM.step_ragged`), and commits the step's
argmax tokens back into per-request outputs.  Prompts are consumed in
chunks of ``prefill_chunk`` so a long prompt never stalls the in-flight
decode batch for more than one chunk of rows.  With a
:class:`~repro_torch.serving.paging.PageTable` admission also secures the
request's pages, and with speculative ``headroom`` every request reserves
that many cache positions for the verify step's transient rows.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .paging import PageTable


@dataclasses.dataclass
class Request:
    """One generation request.  ``eos_id=None`` disables EOS termination;
    generation always stops after ``max_new_tokens`` tokens.  The emitted
    sequence includes the EOS token when one is hit.

    ``src`` (encdec only) carries the request's encoder frames [Ss, d]; at
    admission the engine encodes them once and pins the cross K/V into
    the slot's frozen cross cache.  None serves with a zero cross context.

    ``adapter_id`` selects a bank row of the engine's
    :class:`~repro_torch.serving.adapters.AdapterStore` (multi-tenant
    serving); 0 is the reserved null adapter (the bare base model).  The
    engine resolves and validates it at submit time."""

    prompt: np.ndarray            # [P] int32, P >= 1
    max_new_tokens: int
    eos_id: Optional[int] = None
    rid: int = -1                 # assigned by Scheduler.submit
    src: Optional[np.ndarray] = None  # [Ss, d] encoder frames (encdec)
    adapter_id: int = 0           # AdapterStore bank row (0 = null)


@dataclasses.dataclass
class Slot:
    """In-flight state of one cache slot."""

    req: Request
    pp: int = 0                   # prompt tokens already fed to the model
    emitted: Optional[List[int]] = None
    last_tok: int = 0             # last generated token (decode input)
    # a held draft for the token after last_tok (the reference's MTP
    # drafter); -1 = none, and any plain commit drops it
    spec_draft: int = -1

    def __post_init__(self):
        if self.emitted is None:
            self.emitted = []

    @property
    def prefilling(self) -> bool:
        return self.pp < len(self.req.prompt)

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.emitted)


class Scheduler:
    """FIFO admission into ``n_slots`` cache slots with per-slot eviction.

    ``page_table`` switches admission to paged-cache accounting: a request
    enters a free slot only when the page table can cover it; otherwise
    admission backs off (the request stays queued, the table's
    ``alloc_backoffs`` counts the stall).  A prefix hit at admission
    advances the slot's prompt cursor past the reused tokens (their
    prefill chunks never run); as prefill fills whole prompt pages,
    :meth:`commit` registers them for reuse, and releasing a slot (finish
    or eviction) returns its pages in the same call.

    ``headroom`` (speculative decoding): a verify dispatch writes up to
    that many cache rows past the committed stream before the rejected
    tail rolls back, so every request reserves that many extra positions
    (within ``max_len``, and within its pages)."""

    def __init__(self, n_slots: int, max_len: int, prefill_chunk: int = 8,
                 page_table: Optional[PageTable] = None, headroom: int = 0):
        if n_slots < 1 or prefill_chunk < 1 or headroom < 0:
            raise ValueError(f"need n_slots >= 1, prefill_chunk >= 1 and "
                             f"headroom >= 0; got {n_slots}, "
                             f"{prefill_chunk}, {headroom}")
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.page_table = page_table
        self.headroom = headroom
        self.queue: deque = deque()
        self.slots: List[Optional[Slot]] = [None] * n_slots
        self.outputs: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._seen_rids = set()

    # ---------------- submission / admission ----------------

    def submit(self, req: Request) -> int:
        # ValueError, not assert: these guard public-API input (an
        # oversized request would otherwise drop cache writes past
        # capacity and return wrong tokens)
        if len(req.prompt) < 1:
            raise ValueError("empty prompt: feed BOS explicitly")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = len(req.prompt) + req.max_new_tokens + self.headroom
        extra = (f" (+{self.headroom} speculative headroom)"
                 if self.headroom else "")
        if need > self.max_len:
            raise ValueError(
                f"request needs {len(req.prompt)} + {req.max_new_tokens}"
                f"{extra} cache positions but slots hold {self.max_len}")
        if self.page_table is not None and not self.page_table.fits(need):
            # waiting for pages that can never exist would stall the FIFO
            raise ValueError(
                f"request needs {len(req.prompt)} + {req.max_new_tokens}"
                f"{extra} cache positions but the page pool can never "
                f"cover it (capacity {self.page_table.capacity} pages of "
                f"{self.page_table.page_size})")
        if req.rid < 0:
            req.rid = self._next_rid
        # auto-assignment always skips past pre-assigned rids, and a
        # duplicate pre-assigned rid fails loudly instead of overwriting
        # the earlier request's output
        if req.rid in self._seen_rids:
            raise ValueError(f"duplicate rid {req.rid}")
        self._seen_rids.add(req.rid)
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.queue.append(req)
        return req.rid

    def admit(self) -> List[int]:
        """Move queued requests into free slots; returns the refilled slot
        indices (the engine resets their cache lengths — the slot's stale
        KV from the previous occupant is never read because every
        attention mask is bounded by the slot's own length).

        With a page table, each admission first secures its pages; when
        the pool cannot cover the queue head, admission STOPS (FIFO order
        holds: a later, smaller request does not jump a starved head) and
        the head retries next step.  A prefix hit starts the slot's prompt
        cursor past the reused tokens (the engine seeds the slot's cache
        length to match)."""
        filled = []
        for i in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[i] is None:
                req = self.queue[0]
                reused = 0
                if self.page_table is not None:
                    # the adapter id salts the prefix hashes: a prompt's KV
                    # depends on the adapter that computed it
                    got = self.page_table.admit(
                        i, req.prompt,
                        len(req.prompt) + req.max_new_tokens + self.headroom,
                        salt=req.adapter_id)
                    if got is None:
                        break          # backoff: the head stays queued
                    _, reused = got
                self.queue.popleft()
                self.slots[i] = Slot(req=req, pp=reused)
                filled.append(i)
        return filled

    def _finish(self, i: int, s: Slot):
        """Record slot ``i``'s output and free it (and its pages)."""
        self.outputs[s.req.rid] = s.emitted
        self.slots[i] = None
        if self.page_table is not None:
            self.page_table.release(i)

    def evict_slot(self, i: int) -> Optional[Slot]:
        """Free slot ``i`` WITHOUT recording an output (cancellation or
        deadline expiry).  Returns the evicted slot (partial ``emitted``
        intact) or None if it was free.  The slot's pages are released in
        the same call."""
        s = self.slots[i]
        self.slots[i] = None
        if s is not None and self.page_table is not None:
            self.page_table.release(i)
        return s

    def remove_queued(self, rid: int) -> bool:
        """Drop a not-yet-admitted request from the queue.  True iff it
        was found."""
        for idx, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[idx]
                return True
        return False

    @property
    def queue_depth(self) -> int:
        """Requests admitted by submit() but not yet in a slot."""
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def slot_adapter_ids(self) -> np.ndarray:
        """Per-slot adapter index vector ``[n_slots] int32`` (free slots
        map to the null adapter 0 — their rows are masked anyway)."""
        ids = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                ids[i] = s.req.adapter_id
        return ids

    def live_adapter_ids(self) -> set:
        """Adapter ids referenced by any queued or in-flight request (the
        store's eviction guard)."""
        ids = {s.req.adapter_id for s in self.slots if s is not None}
        ids.update(r.adapter_id for r in self.queue)
        ids.discard(0)
        return ids

    @property
    def all_decoding(self) -> bool:
        """True when every occupied slot is past its prompt (burst-able)."""
        return (self.n_active > 0
                and all(s is None or not s.prefilling for s in self.slots))

    # ---------------- ragged step plan / commit ----------------

    def plan(self):
        """Build the next ragged step: (tokens [B, C], n_new [B]).

        C is 1 when every active slot is decoding, else ``prefill_chunk``
        (decode slots ride along in column 0 with n_new == 1 — in-flight
        batching).  Advances prompt cursors; :meth:`commit` must be called
        with the step's argmax tokens before the next plan."""
        c = self.prefill_chunk if any(
            s is not None and s.prefilling for s in self.slots) else 1
        tokens = np.zeros((self.n_slots, c), np.int32)
        n_new = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.prefilling:
                take = min(c, len(s.req.prompt) - s.pp)
                tokens[i, :take] = s.req.prompt[s.pp:s.pp + take]
                n_new[i] = take
                s.pp += take
            else:
                tokens[i, 0] = s.last_tok
                n_new[i] = 1
        self._planned = n_new
        return tokens, n_new

    def commit(self, next_tokens: np.ndarray) -> List[int]:
        """Record the step's argmax tokens; returns rids finished (and
        evicted) this step.  A slot whose plan consumed its final prompt
        token emits its FIRST generated token here.

        Paged: the step whose results arrive here has written its rows on
        the device, so the prompt pages it completed become registrable
        for reuse now (never earlier: a hit on an unwritten page would read
        garbage), and before any release below, so a finishing request's
        prompt pages park in the reusable cached pool."""
        done = []
        pt = self.page_table
        for i, s in enumerate(self.slots):
            if s is None or self._planned[i] == 0:
                continue  # free or idle
            if pt is not None:
                pt.register_filled(i, s.pp)
            if s.prefilling:
                continue  # still mid-prompt: logits are noise
            tok = int(next_tokens[i])
            s.emitted.append(tok)
            s.last_tok = tok
            s.spec_draft = -1   # the stream moved past the held draft
            if s.remaining <= 0 or (s.req.eos_id is not None
                                    and tok == s.req.eos_id):
                self._finish(i, s)
                done.append(s.req.rid)
        return done

    # ---------------- decode-burst interface ----------------

    def burst_state(self):
        """Per-slot (tok, remaining, eos) vectors for a fused decode burst.
        Only valid when :attr:`all_decoding`; idle slots get remaining=0."""
        tok = np.zeros((self.n_slots,), np.int32)
        remaining = np.zeros((self.n_slots,), np.int32)
        eos = np.full((self.n_slots,), -1, np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok[i] = s.last_tok
            remaining[i] = s.remaining
            if s.req.eos_id is not None:
                eos[i] = s.req.eos_id
        return tok, remaining, eos

    # ---------------- speculative-decode interface ----------------

    def spec_drafts(self) -> np.ndarray:
        """Per-slot held draft tokens ``[n_slots] int32`` (-1 = none: a
        free or fresh slot, or a draft dropped by a plain commit)."""
        d = np.full((self.n_slots,), -1, np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                d[i] = s.spec_draft
        return d

    def set_spec_drafts(self, drafts: np.ndarray):
        """Hold each live slot's draft for the next dispatch (free slots
        are skipped; -1 clears)."""
        for i, s in enumerate(self.slots):
            if s is not None:
                s.spec_draft = int(drafts[i])

    def commit_spec(self, emitted: np.ndarray, m: np.ndarray) -> List[int]:
        """Fold one draft-and-verify dispatch back in.  ``emitted`` [B, C]
        holds each slot's accepted greedy run left-aligned (-1 past
        ``m[b]``; :func:`repro_torch.serving.speculative.accept_drafts`
        has applied the remaining and EOS cuts, so every entry commits).  A
        slot finishes when its allowance is spent or its run holds its EOS
        (the stream keeps the EOS).  Valid once every slot is past its
        prompt."""
        done = []
        for i, s in enumerate(self.slots):
            if s is None or int(m[i]) <= 0:
                continue
            toks = [int(t) for t in emitted[i, :int(m[i])]]
            s.emitted.extend(toks)
            s.last_tok = toks[-1]
            if s.remaining <= 0 or (s.req.eos_id is not None
                                    and s.req.eos_id in toks):
                self._finish(i, s)
                done.append(s.req.rid)
        return done

    def commit_burst(self, emitted: np.ndarray, tok: np.ndarray,
                     remaining: np.ndarray) -> List[int]:
        """Fold a K-step fused burst back in.  ``emitted`` [K, B] holds -1
        where a slot was idle/finished; ``remaining`` is the device-side
        count of tokens each slot may still emit."""
        done = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            toks = [int(t) for t in emitted[:, i] if t >= 0]
            s.emitted.extend(toks)
            s.last_tok = int(tok[i])
            if int(remaining[i]) <= 0:
                self._finish(i, s)
                done.append(s.req.rid)
        return done
