"""Host-side page pool for the paged KV cache (counterpart of
``repro.serving.paging``).

The continuous engine's contiguous cache reserves ``max_len`` tokens per
slot, so device memory = slots x the LONGEST request the engine must ever
hold, and N requests sharing a system prompt cache (and prefill) it N
times.  :class:`PageTable` replaces that with block-granular accounting
over a fixed pool of ``n_pages`` pages of ``page_size`` tokens each:

  * **admission** allocates exactly the pages a request needs
    (``ceil((prompt + max_new) / page_size)``) from a free list, so
    capacity is pooled across slots instead of reserved per slot;
  * **allocation failure is loud backoff**: when the pool cannot cover a
    request, :meth:`PageTable.admit` returns ``None`` and the scheduler
    leaves the request queued (``alloc_backoffs`` counts the stalls);
    pages are never overwritten;
  * **hash-based prefix reuse**: as a slot's prompt pages fill during
    prefill, each FULL page is registered under the token prefix it
    completes (salted by the request's adapter id).  A later request whose
    prompt starts with the same tokens maps its leading page-table entries
    to the existing pages (refcounted) and skips their prefill chunks.
    Reuse only ever covers full prompt pages, and new tokens always land
    in pages the request allocated itself, so shared pages are never
    written again (no copy-on-write);
  * **free-but-cached pages**: a registered page whose refcount drops to
    0 parks in an LRU "cached" pool instead of the free list: still
    hittable by later prompts, reclaimed (hash dropped) only when the free
    list runs dry.

Page 0 is the reserved NULL page: every unmapped page-table entry points
at it, and the device-side insert sends masked rows there.  It is never
allocated, never registered, and never read with a nonzero attention
weight (every attention mask is bounded by the slot's own length, which
never reaches an unmapped page).

Numpy only (neither torch nor jax), so the allocator is property-testable
without a model.  The device side is ``repro_torch.models.slot_state``
(CACHE leaves become ``[layers, n_pages, page_size, ...]`` pools) and
``repro_torch.models.attention`` (``paged_view`` gather and the paged
insert); the per-slot page rows live in the cache as an int32 tensor
written in place, so the captured steps replay as the page map churns.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

NULL_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` tokens."""
    return -(-int(n_tokens) // int(page_size))


class PageTable:
    """Free-list page allocator with refcounted hash-based prefix reuse.

    ``n_pages`` counts the whole pool INCLUDING the reserved null page 0,
    matching the device pool's leading dimension; ``capacity`` (usable
    pages) is therefore ``n_pages - 1``.
    """

    def __init__(self, n_pages: int, page_size: int, slot_pages: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null page); "
                f"got {n_pages}")
        if slot_pages < 1:
            raise ValueError(f"slot_pages must be >= 1; got {slot_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.slot_pages = slot_pages          # page-row width per slot
        # LIFO free list over pages 1..n_pages-1 (0 = null)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros((n_pages,), np.int64)
        # prefix hash table: bytes(prompt[: (k+1) * page_size]) -> page.
        # The FULL prefix is the key (exact match), so hash collisions
        # can never alias two different prefixes to one page.
        self._key2page: Dict[bytes, int] = {}
        self._page2key: Dict[int, bytes] = {}
        # refcount-0 pages that still carry a registered prefix: LRU
        # ordered (oldest first), reclaimed only when the free list is dry
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # per-slot state
        self._slot_pages: Dict[int, List[int]] = {}
        self._slot_prompt: Dict[int, np.ndarray] = {}
        self._slot_salt: Dict[int, int] = {}
        self._slot_registered: Dict[int, int] = {}  # prompt pages hashed
        self._admit_reused: Dict[int, int] = {}     # tokens reused at admit
        # observability
        self.alloc_backoffs = 0       # admissions refused for lack of pages
        self.reused_tokens_total = 0  # prefill tokens skipped via reuse
        self.peak_used = 0            # max concurrently-referenced pages

    # ---------------- capacity ----------------

    @property
    def capacity(self) -> int:
        """Usable pages (the pool minus the null page)."""
        return self.n_pages - 1

    @property
    def n_used(self) -> int:
        """Pages currently referenced by at least one slot."""
        return int((self.ref > 0).sum())

    @property
    def n_free(self) -> int:
        """Pages allocatable right now (truly free + cached-reclaimable)."""
        return len(self._free) + len(self._cached)

    def fits(self, total_tokens: int) -> bool:
        """Whether a request of ``total_tokens`` could EVER be admitted
        (even into an empty pool) — the submit-time loud-rejection check."""
        n = pages_for(total_tokens, self.page_size)
        return n <= min(self.capacity, self.slot_pages)

    # ---------------- admission ----------------

    @staticmethod
    def _key(salt: int, prompt: np.ndarray, k: int, ps: int) -> bytes:
        """Exact-match prefix key: ``salt`` + the first k+1 pages' tokens.
        The salt partitions the hash space per KV-producing context: the
        scheduler passes the request's adapter id, because a prompt's KV
        depends on which adapter computed it (without the salt, tenant B
        would serve tenant A's cached KV for a shared prompt)."""
        return np.int64(salt).tobytes() + prompt[: (k + 1) * ps].tobytes()

    def _prefix_hits(self, prompt: np.ndarray, salt: int) -> List[int]:
        """Longest chain of registered full-page prefix hits, capped so at
        least the LAST prompt token is always recomputed (its model step
        produces the first generated token's logits)."""
        ps = self.page_size
        max_pages = (len(prompt) - 1) // ps   # cap: never the whole prompt
        hits: List[int] = []
        for k in range(max_pages):
            page = self._key2page.get(self._key(salt, prompt, k, ps))
            if page is None:
                break
            hits.append(page)
        return hits

    def _alloc_one(self) -> int:
        if self._free:
            return self._free.pop()
        # reclaim the LRU cached page: drop its prefix registration
        page, _ = self._cached.popitem(last=False)
        key = self._page2key.pop(page)
        del self._key2page[key]
        return page

    def admit(self, slot: int, prompt: np.ndarray, total_tokens: int,
              salt: int = 0) -> Optional[Tuple[np.ndarray, int]]:
        """Try to admit a request into ``slot``: map prefix hits, allocate
        fresh pages for the rest.  Returns ``(page_row [slot_pages] int32,
        reused_tokens)`` or ``None`` (admission backoff — nothing
        allocated, nothing mutated) when the pool can't cover it.
        ``salt`` namespaces the prefix hashes (see :meth:`_key`): prompts
        only ever share pages within the same salt."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds pages; release first")
        prompt = np.asarray(prompt, np.int32)
        n_total = pages_for(total_tokens, self.page_size)
        if n_total > self.slot_pages:
            raise ValueError(
                f"request needs {n_total} pages but a slot's page row holds "
                f"{self.slot_pages}")
        hits = self._prefix_hits(prompt, salt)
        n_fresh = n_total - len(hits)
        # hits parked in the cached pool will be revived (not reclaimable
        # for fresh allocation), so subtract them from the free estimate
        free_for_fresh = (len(self._free) + len(self._cached)
                          - sum(1 for p in hits if p in self._cached))
        if n_fresh > free_for_fresh:
            self.alloc_backoffs += 1
            return None
        pages = []
        for p in hits:                       # revive/share prefix pages
            if self.ref[p] == 0:
                del self._cached[p]
            self.ref[p] += 1
            pages.append(p)
        for _ in range(n_fresh):             # private tail pages
            p = self._alloc_one()
            self.ref[p] += 1
            pages.append(p)
        reused = len(hits) * self.page_size
        self._slot_pages[slot] = pages
        self._slot_prompt[slot] = prompt
        self._slot_salt[slot] = salt
        self._slot_registered[slot] = len(hits)
        self._admit_reused[slot] = reused
        self.reused_tokens_total += reused
        self.peak_used = max(self.peak_used, self.n_used)
        row = np.full((self.slot_pages,), NULL_PAGE, np.int32)
        row[: len(pages)] = pages
        return row, reused

    # ---------------- prefix registration ----------------

    def register_filled(self, slot: int, prompt_progress: int):
        """Register prefix hashes for the slot's prompt pages that are now
        FULLY written on device (prompt cursor at ``prompt_progress``).
        Called after each committed step; idempotent per page.  Pages the
        slot itself reused arrived registered (shared), so registration
        starts past them.  Never registers a partial page, never a page
        holding generated tokens."""
        if slot not in self._slot_pages:
            return
        ps = self.page_size
        prompt = self._slot_prompt[slot]
        salt = self._slot_salt[slot]
        full = min(prompt_progress, len(prompt)) // ps
        pages = self._slot_pages[slot]
        for k in range(self._slot_registered[slot], full):
            key = self._key(salt, prompt, k, ps)
            page = pages[k]
            # first writer wins: identical content may already be
            # registered by a concurrent slot — keep the existing mapping
            if key not in self._key2page and page not in self._page2key:
                self._key2page[key] = page
                self._page2key[page] = key
        self._slot_registered[slot] = full

    # ---------------- release ----------------

    def release(self, slot: int):
        """Drop the slot's references.  A page whose refcount hits 0 goes
        back to the free list — or, if it carries a registered prefix, to
        the LRU cached pool (still hittable, reclaimed last)."""
        for p in self._slot_pages.pop(slot, []):
            self.ref[p] -= 1
            assert self.ref[p] >= 0, f"refcount underflow on page {p}"
            if self.ref[p] == 0:
                if p in self._page2key:
                    self._cached[p] = None   # most-recently-used end
                else:
                    self._free.append(p)
        self._slot_prompt.pop(slot, None)
        self._slot_salt.pop(slot, None)
        self._slot_registered.pop(slot, None)
        self._admit_reused.pop(slot, None)

    # ---------------- views ----------------

    def page_row(self, slot: int) -> np.ndarray:
        """The slot's device page-index row ``[slot_pages] int32`` (null-
        padded past its allocation)."""
        row = np.full((self.slot_pages,), NULL_PAGE, np.int32)
        pages = self._slot_pages.get(slot, [])
        row[: len(pages)] = pages
        return row

    def slot_reused_tokens(self, slot: int) -> int:
        """Tokens of ``slot``'s prompt served from shared pages."""
        return self._admit_reused.get(slot, 0)

    def check_invariants(self):
        """Debug/property-test hook: internal accounting must balance."""
        live = {p for ps in self._slot_pages.values() for p in ps}
        counts = np.zeros_like(self.ref)
        for ps_ in self._slot_pages.values():
            for p in ps_:
                counts[p] += 1
        assert (counts == self.ref).all(), "refcounts out of sync"
        assert NULL_PAGE not in live, "null page allocated"
        assert not (set(self._free) & live), "live page on the free list"
        assert not (set(self._cached) & live), "live page in the cached pool"
        assert not (set(self._free) & set(self._cached)), \
            "page both free and cached"
        assert (len(self._free) + len(self._cached) + len(live)
                == self.capacity), "pages leaked or double-counted"
        for key, page in self._key2page.items():
            assert self._page2key.get(page) == key, "hash maps out of sync"
