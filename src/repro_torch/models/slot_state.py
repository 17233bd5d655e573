"""Per-slot decode state for the gqa layout (gqa and gqa_moe), contiguous
or paged (counterpart of the gqa part of ``repro.models.slot_state``).

A contiguous decode cache is ``{"layers": {"k": [L, B, S, KvH, hd], "v":
...}, "len": [B] int32}``: KV rows past a slot's ``len`` are never read
(every attention mask is bounded by it).  With ``page_size > 0`` the K/V
leaves are pools ``[L, n_pages, page_size, KvH, hd]`` shared by every
slot (page 0 the reserved null page, see
:mod:`repro_torch.serving.paging`), and ``"pages": [B, slot_pages]``
int32 maps each slot's positions to pool pages.  Every step writes the
cache in place, and so do admission, eviction and rollback, so it keeps
its addresses, as a captured serve step needs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from .attention import AttnConfig


# the families the port serves: LM and SlotState refuse the rest through
# check_family
FAMILIES = ("gqa", "gqa_moe")


def check_family(cfg: ArchConfig):
    """Raise NotImplementedError for a family the port does not serve."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (see ROADMAP.md); "
            f"the port serves {', '.join(FAMILIES)}")


def attn_cfg(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                      rope_theta=cfg.rope_theta, window=cfg.window,
                      qk_norm=cfg.qk_norm)


@dataclasses.dataclass(frozen=True)
class SlotState:
    """Layout and lifecycle of one config's decode cache.  ``page_size >
    0`` selects the paged layout of ``n_pages`` pages (the null page
    included)."""

    cfg: ArchConfig
    page_size: int = 0
    n_pages: int = 0

    def __post_init__(self):
        check_family(self.cfg)
        if self.page_size > 0 and self.n_pages < 2:
            raise ValueError(
                f"paged mode needs n_pages >= 2 (page 0 is the reserved "
                f"null page); got {self.n_pages}")

    def slot_pages(self, max_len: int) -> int:
        """Page-row width of a slot: pages covering ``max_len`` tokens."""
        return -(-max_len // self.page_size)

    def supports_rollback(self) -> bool:
        """Whether a step can be partly undone by shrinking ``len`` (what
        speculative decoding's rollback needs).  True for this layout: a
        step writes only length-indexed K/V rows and ``len``, and every
        read is bounded by ``len``; the page map changes only at admission
        and eviction."""
        return True

    def init(self, n_slots: int, max_len: int, dtype=torch.bfloat16,
             device="cuda") -> dict:
        """Fresh all-slots-empty decode cache."""
        cfg = self.cfg
        kv = (cfg.n_kv_heads, cfg.head_dim)
        if self.page_size > 0:
            shape = (cfg.n_layers, self.n_pages, self.page_size) + kv
        else:
            shape = (cfg.n_layers, n_slots, max_len) + kv
        cache = {"layers": {"k": torch.zeros(shape, dtype=dtype,
                                             device=device),
                            "v": torch.zeros(shape, dtype=dtype,
                                             device=device)},
                 "len": torch.zeros((n_slots,), dtype=torch.int32,
                                    device=device)}
        if self.page_size > 0:
            cache["pages"] = torch.zeros(
                (n_slots, self.slot_pages(max_len)), dtype=torch.int32,
                device=device)
        return cache

    def reset(self, cache, mask) -> dict:
        """Evict the masked slots (``mask [n_slots]`` bool), in place: their
        lengths go to 0 and their page rows to the null page; their KV rows
        stay in place, masked by the length, never read.  Returns
        ``cache``."""
        cache["len"].masked_fill_(mask, 0)
        if "pages" in cache:
            cache["pages"].masked_fill_(mask[:, None], 0)
        return cache

    def advance(self, cache, n_new) -> dict:
        """Advance each slot's length by the rows its step consumed, in
        place (a captured step leaves the cache at its addresses).  Returns
        ``cache``."""
        cache["len"].add_(n_new.to(torch.int32))
        return cache

    def clear(self, cache) -> dict:
        """Every slot empty, every page row null and every K/V row zero, in
        place (an engine reset: stale rows of a poisoned cache would reach
        the attention's products)."""
        for t in (*cache["layers"].values(), cache["len"],
                  *([cache["pages"]] if "pages" in cache else [])):
            t.zero_()
        return cache
