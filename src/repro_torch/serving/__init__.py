"""Continuous-batching serving with multi-tenant QA-LoRA adapters
(counterpart of ``repro.serving``: gqa, contiguous KV cache).

    from repro_torch.serving import AdapterStore, ContinuousEngine
    store = AdapterStore(base_params, capacity=8)
    store.register("tenant-a", trained_tree_a)
    eng = ContinuousEngine(lm, store.base, n_slots=4, max_len=64,
                           adapters=store)
    rid = eng.submit(prompt_ids, 16, adapter_id="tenant-a")
    outputs = eng.run()          # {rid: [tok, ...]}
    eng.stats.tok_per_s, eng.stats.occupancy

``scheduler`` and ``trace`` are numpy only; the engine and the store hold
torch tensors.
"""

from .adapters import AdapterStore, extract_pack
from .engine import ContinuousEngine, EngineCorrupted, EngineStats
from .scheduler import Request, Scheduler, Slot
from .trace import (bursty_arrivals, make_trace, poisson_arrivals, replay,
                    static_schedule)

__all__ = ["AdapterStore", "ContinuousEngine", "EngineCorrupted",
           "EngineStats", "Request", "Scheduler", "Slot", "bursty_arrivals",
           "extract_pack", "make_trace", "poisson_arrivals", "replay",
           "static_schedule"]
