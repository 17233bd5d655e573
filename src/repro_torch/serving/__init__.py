"""Continuous-batching serving with multi-tenant QA-LoRA adapters, a
paged KV cache and speculative decoding (counterpart of ``repro.serving``,
for every family).

    from repro_torch.serving import AdapterStore, ContinuousEngine
    store = AdapterStore(base_params, capacity=8)
    store.register("tenant-a", trained_tree_a)
    eng = ContinuousEngine(lm, store.base, n_slots=4, max_len=64,
                           adapters=store)
    rid = eng.submit(prompt_ids, 16, adapter_id="tenant-a")
    outputs = eng.run()          # {rid: [tok, ...]}
    eng.stats.tok_per_s, eng.stats.occupancy

    # live traffic: bounded intake, deadlines, typed terminal statuses,
    # crash recovery, graceful drain
    fe = ServingFrontend(lm, merged, n_slots=4, max_len=64,
                         queue_cap=32).start()
    t = fe.submit(prompt_ids, 16, deadline_s=2.0)   # any thread
    fe.stop()                    # drain; t.status / t.tokens / t.ttft

    # paged cache with prefix reuse, and self-speculation at 8 bits
    eng = ContinuousEngine(lm, merged, n_slots=4, max_len=64, page_size=16,
                           decode_burst=1, speculate=3, drafter="*=intq8")

``scheduler``, ``paging``, ``speculative`` and ``trace`` are numpy only; the
engine and the store hold torch tensors; the frontend drives the engine.
"""

from .adapters import AdapterStore, extract_pack
from .engine import (ContinuousEngine, EngineCorrupted, EngineStats,
                     make_self_drafter)
from .frontend import (RequestStatus, ServingFrontend, Ticket,
                       TERMINAL_STATUSES, slo_summary)
from .paging import PageTable, pages_for
from .scheduler import Request, Scheduler, Slot
from .speculative import accept_drafts, rollback_counts
from .trace import (bursty_arrivals, make_trace, poisson_arrivals, replay,
                    static_schedule)

__all__ = ["AdapterStore", "ContinuousEngine", "EngineCorrupted",
           "EngineStats", "PageTable", "Request", "RequestStatus",
           "Scheduler", "ServingFrontend", "Slot", "Ticket",
           "TERMINAL_STATUSES", "accept_drafts", "bursty_arrivals",
           "extract_pack", "make_self_drafter", "make_trace", "pages_for",
           "poisson_arrivals", "replay", "rollback_counts", "slo_summary",
           "static_schedule"]
