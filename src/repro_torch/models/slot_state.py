"""Per-slot decode state for the contiguous gqa layout (counterpart of the
gqa part of ``repro.models.slot_state``).

A decode cache is ``{"layers": {"k": [L, B, S, KvH, hd], "v": ...},
"len": [B] int32}``: KV rows past a slot's ``len`` are never read (every
attention mask is bounded by it).
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
        """Evict the masked slots (``mask [n_slots]`` bool): their lengths
        go to 0; their KV rows stay in place, masked by the length, never
        read."""
        return {"layers": cache["layers"],
                "len": torch.where(mask, torch.zeros_like(cache["len"]),
                                   cache["len"])}

    def advance(self, cache, layers, n_new) -> dict:
        """Fold a step's layer state back in, advancing each slot's length
        by the rows it consumed."""
        return {"layers": layers,
                "len": cache["len"] + n_new.to(torch.int32)}
