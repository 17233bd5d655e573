"""Per-slot decode state for the contiguous gqa layout (counterpart of the
gqa part of ``repro.models.slot_state``).

A decode cache is ``{"layers": {"k": [L, B, S, KvH, hd], "v": ...},
"len": [B] int32}``: KV rows past a slot's ``len`` are never read (every
attention mask is bounded by it).  Every step writes the cache in place, so
it keeps its addresses, as a captured serve step needs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from .attention import AttnConfig


def attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                      rope_theta=cfg.rope_theta, window=cfg.window,
                      qk_norm=cfg.qk_norm)


@dataclasses.dataclass(frozen=True)
class SlotState:
    """Layout and lifecycle of one config's decode cache."""

    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family != "gqa":
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (see "
                f"ROADMAP.md); the port serves gqa")

    def init(self, n_slots: int, max_len: int, dtype=torch.bfloat16,
             device="cuda") -> dict:
        """Fresh all-slots-empty decode cache."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)},
                "len": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device)}

    def reset(self, cache, mask) -> dict:
        """Evict the masked slots (``mask [n_slots]`` bool), in place: their
        lengths go to 0; their KV rows stay in place, masked by the length,
        never read.  Returns ``cache``."""
        cache["len"].masked_fill_(mask, 0)
        return cache

    def advance(self, cache, n_new) -> dict:
        """Advance each slot's length by the rows its step consumed, in
        place (a captured step leaves the cache at its addresses).  Returns
        ``cache``."""
        cache["len"].add_(n_new.to(torch.int32))
        return cache

    def clear(self, cache) -> dict:
        """Every slot empty and every K/V row zero, in place (an engine
        reset: stale rows of a poisoned cache would reach the attention's
        products)."""
        for t in (*cache["layers"].values(), cache["len"]):
            t.zero_()
        return cache
