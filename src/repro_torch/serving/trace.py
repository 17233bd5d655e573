"""Mixed-length request traces and arrival processes (counterpart of
``repro.serving.trace``), in numpy only.

A trace is a list of :class:`~repro_torch.serving.scheduler.Request`s with
heterogeneous prompt and generation lengths — the workload where static
batching wastes slots and continuous batching refills them.  Arrival
times come from :func:`poisson_arrivals` (open-loop memoryless traffic)
or :func:`bursty_arrivals` (synchronized bursts at the same mean rate),
replayed against any ``submit`` callable by :func:`replay`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import Request


def make_trace(n_requests: int, vocab: int, *, seed: int = 0,
               prompt_lens: Sequence[int] = (3, 5, 8),
               gen_lens: Sequence[int] = (2, 4, 12),
               eos_id: Optional[int] = None,
               adapter_ids: Optional[Sequence] = None,
               store=None, shared_prefix: int = 0) -> List[Request]:
    """Random-token requests cycling through the given length mixes.

    Lengths are drawn round-robin (not sampled) so a trace is exactly
    reproducible and every length appears; token ids avoid 0..3.

    ``adapter_ids`` cycles round-robin like the lengths: entry ``i % len``
    binds request ``i`` to that adapter (name, id, or 0/None for the bare
    base).  Pass ``store`` to resolve names and validate every id up front.

    ``shared_prefix > 0`` prepends the SAME ``shared_prefix`` random tokens
    (one seeded draw) to every prompt; prompt lengths then count the
    per-request tail."""
    if vocab <= 4:
        raise ValueError(
            f"make_trace needs vocab > 4 (token ids are drawn from "
            f"[4, vocab), skipping reserved-ish ids 0..3); got {vocab}")
    aids = [0] * n_requests
    if adapter_ids is not None:
        if len(adapter_ids) < 1:
            raise ValueError("adapter_ids must be a non-empty sequence")
        cycle = [a if a is not None else 0 for a in adapter_ids]
        if store is not None:
            cycle = [store.resolve(a) for a in cycle]  # loud on unknown
        elif any(isinstance(a, str) for a in cycle):
            raise ValueError(
                "adapter_ids contains names; pass store= to resolve them")
        aids = [int(cycle[i % len(cycle)]) for i in range(n_requests)]
    rng = np.random.default_rng(seed)
    prefix = rng.integers(4, vocab, size=(shared_prefix,)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        p = int(prompt_lens[i % len(prompt_lens)])
        g = int(gen_lens[i % len(gen_lens)])
        prompt = rng.integers(4, vocab, size=(p,)).astype(np.int32)
        if shared_prefix:
            prompt = np.concatenate([prefix, prompt])
        reqs.append(Request(prompt=prompt, max_new_tokens=g, eos_id=eos_id,
                            rid=i, adapter_id=aids[i]))
    return reqs


def poisson_arrivals(n: int, rate: float, *, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds from t=0) of an open-loop Poisson process
    at ``rate`` requests/second."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s; got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, *, burst: int = 4,
                    seed: int = 0) -> np.ndarray:
    """Arrival offsets with the SAME mean rate as :func:`poisson_arrivals`:
    requests land in synchronized groups of ``burst``, with exponential
    gaps of mean ``burst / rate`` between groups."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s; got {rate}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1; got {burst}")
    rng = np.random.default_rng(seed)
    n_groups = -(-n // burst)
    gaps = rng.exponential(burst / rate, size=n_groups)
    return np.repeat(np.cumsum(gaps), burst)[:n]


def replay(submit: Callable[[Request], object], reqs: List[Request],
           arrivals: Sequence[float], *, speed: float = 1.0,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep) -> List[object]:
    """Open-loop replay: call ``submit(req)`` at each arrival offset
    (scaled by ``1/speed``) whether or not the server keeps up.  Returns
    submit's results in arrival order.  ``clock``/``sleep`` are injectable
    so tests can replay virtually."""
    if len(reqs) != len(arrivals):
        raise ValueError(f"{len(reqs)} requests vs {len(arrivals)} arrivals")
    t0 = clock()
    out = []
    for req, at in zip(reqs, arrivals):
        delay = at / speed - (clock() - t0)
        if delay > 0:
            sleep(delay)
        out.append(submit(req))
    return out


def static_schedule(reqs: List[Request],
                    n_slots: int) -> List[Tuple[List[Request], int]]:
    """FIFO static batching plan: groups of ``n_slots`` requests, each
    decoding max(max_new_tokens) steps.  Returns [(group, gen_len), ...]."""
    groups = []
    for i in range(0, len(reqs), n_slots):
        grp = reqs[i:i + n_slots]
        groups.append((grp, max(r.max_new_tokens for r in grp)))
    return groups
