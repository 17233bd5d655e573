"""Config registry: ``get(name)`` returns the full config, ``reduced(name)``
a same-family CPU-smoke-size config (counterpart of ``repro.configs``;
only the archs ported so far are registered)."""

from __future__ import annotations

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

from . import gemma3_1b, llama7b_proxy

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (gemma3_1b, llama7b_proxy)}


def get(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet (see ROADMAP.md); "
                       f"ported: {sorted(REGISTRY)}")


SMOKE_QUANT = QuantPolicy(bits=4, group_size=16, rank=4, dtype=torch.float32,
                          scale_dtype=torch.float32)


def reduced(name: str, **over) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests, with the reference's
    reductions (layers, width, vocab, window, chunks, no remat)."""
    cfg = get(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16, d_ff=96,
        vocab=256, window=min(cfg.window or 0, 8) or None, chunk_q=16,
        chunk_k=16, xent_chunk=16, quant=SMOKE_QUANT, remat=False,
    )
    if cfg.global_every:
        kw.update(global_every=2)
    kw.update(over)
    return cfg.scaled(**kw)


__all__ = ["ArchConfig", "REGISTRY", "SMOKE_QUANT", "get", "reduced"]
