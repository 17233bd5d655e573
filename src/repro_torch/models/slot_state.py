"""Per-slot decode state for the gqa layout (gqa and gqa_moe) and the
mla layout (mla_moe), contiguous or paged (counterpart of those layouts
of ``repro.models.slot_state``).

A contiguous gqa decode cache is ``{"layers": {"k": [L, B, S, KvH, hd],
"v": ...}, "len": [B] int32}``; an mla_moe one holds the compressed
latent and the rope key of its dense and its MoE layers, ``{"layers":
{"dense": {"c": [L_d, B, S, rank], "kr": [L_d, B, S, rope]}, "moe":
{"c": [L_m, ...], "kr": ...}}, "len": ...}``.  Rows past a slot's
``len`` are never read (every attention mask is bounded by it).  With
``page_size > 0`` each leaf's (slot, position) axes become the pool's
(page, offset) axes, ``[L, n_pages, page_size, ...]``, shared by every
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
from .attention import AttnConfig, MLAConfig


# the families the port serves: LM and SlotState refuse the rest through
# check_family
FAMILIES = ("gqa", "gqa_moe", "mla_moe")


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


def mla_cfg(cfg: ArchConfig) -> MLAConfig:
    return MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                     q_lora_rank=cfg.q_lora_rank,
                     kv_lora_rank=cfg.kv_lora_rank,
                     qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                     v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)


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
        speculative decoding's rollback needs).  True for both layouts: a
        step writes only length-indexed cache rows and ``len``, and every
        read is bounded by ``len``; the page map changes only at admission
        and eviction.  (The reference derives it from its leaf kinds: no
        state leaf here advances inside a step.)"""
        return True

    def _leaf_shapes(self) -> dict:
        """The per-layer-stack cache leaves: ``{path: (layers, feature
        dims)}``, ``path`` a key tuple into ``cache["layers"]``."""
        cfg = self.cfg
        if cfg.family == "mla_moe":
            nd = cfg.n_dense_layers
            out = {}
            for part, n in (("dense", nd), ("moe", cfg.n_layers - nd)):
                out[(part, "c")] = (n, (cfg.kv_lora_rank,))
                out[(part, "kr")] = (n, (cfg.qk_rope_dim,))
            return out
        kv = (cfg.n_layers, (cfg.n_kv_heads, cfg.head_dim))
        return {("k",): kv, ("v",): kv}

    def init(self, n_slots: int, max_len: int, dtype=torch.bfloat16,
             device="cuda") -> dict:
        """Fresh all-slots-empty decode cache."""
        layers: dict = {}
        for path, (n, feat) in self._leaf_shapes().items():
            if self.page_size > 0:
                shape = (n, self.n_pages, self.page_size) + feat
            else:
                shape = (n, n_slots, max_len) + feat
            node = layers
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros(shape, dtype=dtype, device=device)
        cache = {"layers": layers,
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
        """Every slot empty, every page row null and every cache row zero, in
        place (an engine reset: stale rows of a poisoned cache would reach
        the attention's products)."""
        for t in (*cache_leaves(cache["layers"]), cache["len"],
                  *([cache["pages"]] if "pages" in cache else [])):
            t.zero_()
        return cache


def cache_leaves(layers) -> list:
    """The tensors of a decode cache's ``layers`` tree, in key order."""
    if isinstance(layers, torch.Tensor):
        return [layers]
    return [t for k in sorted(layers) for t in cache_leaves(layers[k])]
