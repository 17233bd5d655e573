"""Per-slot decode state of every served family, contiguous or paged
(counterpart of ``repro.models.slot_state``).

Every leaf of a decode cache is one of three kinds:

``cache``
    Length-indexed storage (K/V, the compressed latent): rows past a
    slot's ``len`` are never read (every attention mask is bounded by
    it), so eviction leaves them in place.
``state``
    Per-slot state read whatever the length (Mamba2's ``conv`` window and
    ``ssm`` state, RWKV6's ``tm_prev`` / ``wkv`` / ``cm_prev``, the page
    map): eviction must zero it, or the next occupant inherits the last
    one's recurrence (or a poisoned NaN).
``len``
    The per-slot lengths.

The layouts (``cache["layers"]``):

* gqa, gqa_moe: ``{"k": [L, B, S, KvH, hd], "v": ...}``;
* mla_moe: the compressed latent and the rope key of the dense and the
  MoE layers, ``{"dense": {"c": [L_d, B, S, rank], "kr": [L_d, B, S,
  rope]}, "moe": {...}}``;
* mamba_hybrid: ``{"groups": {"conv": [G, P, B, W-1, conv_dim], "ssm":
  [G, P, B, H, hd, N]}, "tail": {"conv": [T, B, ...], "ssm": ...}, "k":
  [G, B, S, KvH, hd], "v": ...}`` (G groups of P Mamba2 layers, each
  followed by the one shared attention block, whose K/V has one entry a
  group; T tail layers);
* rwkv: ``{"tm_prev": [L, B, 1, d], "wkv": [L, B, H, hd, hd], "cm_prev":
  [L, B, 1, d]}``;
* encdec: the decoder's self-attention K/V ``{"self": {"k": [L, B, S,
  KvH, hd], "v": ...}`` (CACHE) and the frozen cross cache ``"cross":
  {"k": [L, B, Ss, KvH, hd], "v": ..., "len": [B]}}`` of capacity
  ``src_cap``, written once at admission.  The cross K/V are STATE, not
  CACHE: nothing masks them but the cross ``len``, so eviction must zero
  them (a src-less request in a refilled slot would otherwise average the
  last occupant's memory), and the cross ``len`` is a LEN leaf.

STATE leaves have their own dtype (f32 for the recurrences, the policy's
dtype for RWKV6's token-shift carries); CACHE leaves take the one the
cache is made with.  With ``page_size > 0`` each CACHE leaf's (slot,
position) axes become the pool's (page, offset) axes, ``[L, n_pages,
page_size, ...]``, shared by every slot (page 0 the reserved null page,
see :mod:`repro_torch.serving.paging`), and ``"pages": [B, slot_pages]``
int32 (a STATE leaf) maps each slot's positions to pool pages; rwkv has
no CACHE leaf and refuses to page (encdec pages its self-attention K/V
only).  Every step writes the cache in place,
and so do admission, eviction and rollback, so it keeps its addresses, as
a captured serve step needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .attention import AttnConfig, MLAConfig
from .ssm import Mamba2Config, RWKV6Config


# the families the port serves: LM and SlotState refuse the rest through
# check_family
FAMILIES = ("gqa", "gqa_moe", "mla_moe", "mamba_hybrid", "rwkv", "encdec")

CACHE, STATE, LEN = "cache", "state", "len"

# the reference's refusal of a paged rwkv engine
RWKV_PAGING = ("rwkv carries no length-indexed CACHE leaves — there is "
               "nothing to page; serve it with page_size=0")


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


def mamba_cfg(cfg: ArchConfig) -> Mamba2Config:
    return Mamba2Config(d_model=cfg.d_model, ssm_state=cfg.ssm_state,
                        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def rwkv_cfg(cfg: ArchConfig) -> RWKV6Config:
    return RWKV6Config(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       head_dim=cfg.ssm_head_dim or 64, chunk=cfg.ssm_chunk)


def hybrid_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_groups, Mamba2 layers a group, tail) of the mamba_hybrid stack:
    each group of ``attn_every`` layers is ``attn_every - 1`` Mamba2 layers
    and one application of the shared attention block."""
    per = cfg.attn_every - 1
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, per, cfg.n_layers - n_groups * cfg.attn_every


@dataclasses.dataclass(frozen=True)
class SlotLeaf:
    """One leaf of a decode cache: its shape (slot axis included), the
    axis that indexes slots, its kind and its dtype (None: the cache's)."""

    shape: Tuple[int, ...]
    slot_axis: int
    kind: str              # CACHE | STATE | LEN
    dtype: Any = None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves_with_keys(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], keys + (k,))
    else:
        yield keys, tree


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
        if self.page_size > 0:
            if self.cfg.family == "rwkv":
                raise ValueError(RWKV_PAGING)
            if self.n_pages < 2:
                raise ValueError(
                    f"paged mode needs n_pages >= 2 (page 0 is the reserved "
                    f"null page); got {self.n_pages}")

    def slot_pages(self, max_len: int) -> int:
        """Page-row width of a slot: pages covering ``max_len`` tokens."""
        return -(-max_len // self.page_size)

    def layout(self, n_slots: int, max_len: int, src_cap: int = 0) -> dict:
        """The cache as a tree of :class:`SlotLeaf` (``layers``, ``len``
        and, paged, ``pages``); ``src_cap`` is encdec's cross-cache
        capacity (frames a slot), unused by the other families."""
        cfg = self.cfg
        B, S = n_slots, max_len

        def kv(n, s=S, kind=CACHE):
            shape = (n, B, s, cfg.n_kv_heads, cfg.head_dim)
            return {"k": SlotLeaf(shape, 1, kind),
                    "v": SlotLeaf(shape, 1, kind)}

        fam = cfg.family
        if fam in ("gqa", "gqa_moe"):
            layers = kv(cfg.n_layers)
        elif fam == "mla_moe":
            nd = cfg.n_dense_layers

            def mk(n):
                return {"c": SlotLeaf((n, B, S, cfg.kv_lora_rank), 1, CACHE),
                        "kr": SlotLeaf((n, B, S, cfg.qk_rope_dim), 1, CACHE)}
            layers = {"dense": mk(nd), "moe": mk(cfg.n_layers - nd)}
        elif fam == "mamba_hybrid":
            ng, per, tail = hybrid_layout(cfg)
            m = mamba_cfg(cfg)

            def mamba_state(lead):
                ax, f32 = len(lead), torch.float32
                return {"conv": SlotLeaf(lead + (B, m.conv_width - 1,
                                                 m.conv_dim), ax, STATE, f32),
                        "ssm": SlotLeaf(lead + (B, m.n_heads, m.head_dim,
                                                m.ssm_state), ax, STATE, f32)}
            layers = {"groups": mamba_state((ng, per)),
                      "tail": mamba_state((tail,)), **kv(ng)}
        elif fam == "encdec":
            layers = {"self": kv(cfg.n_layers),
                      "cross": {**kv(cfg.n_layers, src_cap, STATE),
                                "len": SlotLeaf((B,), 0, LEN, torch.int32)}}
        else:  # rwkv
            r, L, sd = rwkv_cfg(cfg), cfg.n_layers, cfg.quant.dtype
            layers = {
                "tm_prev": SlotLeaf((L, B, 1, cfg.d_model), 1, STATE, sd),
                "wkv": SlotLeaf((L, B, r.n_heads, r.head_dim, r.head_dim), 1,
                                STATE, torch.float32),
                "cm_prev": SlotLeaf((L, B, 1, cfg.d_model), 1, STATE, sd)}
        out = {"layers": layers, "len": SlotLeaf((B,), 0, LEN, torch.int32)}
        if self.page_size > 0:
            out["layers"] = _map(self._page_leaf, layers)
            out["pages"] = SlotLeaf((B, self.slot_pages(max_len)), 0, STATE,
                                    torch.int32)
        return out

    def _page_leaf(self, s: SlotLeaf) -> SlotLeaf:
        """A CACHE leaf's (slot, position) axes become the pool's (page,
        offset) axes; STATE leaves pass through."""
        if s.kind != CACHE:
            return s
        shape = list(s.shape)
        shape[s.slot_axis:s.slot_axis + 2] = [self.n_pages, self.page_size]
        return dataclasses.replace(s, shape=tuple(shape))

    def supports_rollback(self) -> bool:
        """Whether a step can be partly undone by shrinking ``len`` (what
        speculative decoding's rollback needs), derived from the leaf kinds
        as the reference derives it: only when a step writes nothing but
        length-indexed CACHE rows and ``len``.  STATE leaves frozen during
        decode are harmless: encdec's cross cache is written once at
        admission, the page map only at admission and eviction.  A
        recurrent STATE leaf advances inside every step, and a rejected
        draft cannot be un-stepped."""
        spec = self.layout(1, max(self.page_size, 1), src_cap=1)
        frozen = {"cross", "pages"}
        return all(leaf.kind != STATE or frozen & set(keys)
                   for keys, leaf in _leaves_with_keys(spec))

    def init(self, n_slots: int, max_len: int, dtype=torch.bfloat16,
             device="cuda", src_cap: Optional[int] = None) -> dict:
        """Fresh all-slots-empty decode cache (``dtype``: the CACHE leaves'
        and the cross cache's; the other STATE leaves keep their own).

        For encdec with ``src_cap`` None, ``max_len`` is split as the
        reference's ``LM.init_cache`` splits it: ``int(max_len *
        source_frac)`` frames of cross cache and the rest decoder
        positions; an explicit ``src_cap`` leaves ``max_len`` the
        decoder's (what the engine wants)."""
        if self.cfg.family == "encdec" and src_cap is None:
            src_cap = int(max_len * self.cfg.source_frac)
            max_len = max_len - src_cap
        return _map(lambda s: torch.zeros(
            s.shape, dtype=s.dtype or dtype, device=device),
            self.layout(n_slots, max_len, src_cap or 0))

    def _spec(self, cache) -> dict:
        """The layout of ``cache`` (its slots, and encdec's cross
        capacity; the other capacities do not change a leaf's kind)."""
        src_cap = 0
        if self.cfg.family == "encdec":
            src_cap = cache["layers"]["cross"]["k"].shape[2]
        return self.layout(cache["len"].shape[0], 1, src_cap)

    def _kinds(self, cache):
        """(slot axis, kind, tensor) of every leaf of ``cache``."""
        spec = self._spec(cache)
        for keys, leaf in _leaves_with_keys(spec):
            t = cache
            for k in keys:
                t = t[k]
            yield leaf.slot_axis, leaf.kind, t

    def reset(self, cache, mask) -> dict:
        """Evict the masked slots (``mask [n_slots]`` bool), in place: their
        lengths go to 0, their STATE leaves (recurrences, page rows) to
        zero; their CACHE rows stay in place, masked by the length, never
        read.  Returns ``cache``."""
        for axis, kind, t in self._kinds(cache):
            if kind == CACHE:
                continue
            shape = [1] * t.dim()
            shape[axis] = mask.shape[0]
            t.masked_fill_(mask.view(shape), 0)
        return cache

    def state_leaves(self, cache) -> list:
        """The STATE tensors of ``cache["layers"]`` (the recurrences,
        encdec's cross K/V; none for the attention-only families)."""
        spec = self._spec(cache)["layers"]
        out = []
        for keys, leaf in _leaves_with_keys(spec):
            if leaf.kind == STATE:
                t = cache["layers"]
                for k in keys:
                    t = t[k]
                out.append(t)
        return out

    def advance(self, cache, n_new) -> dict:
        """Advance each slot's length by the rows its step consumed, in
        place (a captured step leaves the cache at its addresses).  Returns
        ``cache``."""
        cache["len"].add_(n_new.to(torch.int32))
        return cache

    def clear(self, cache) -> dict:
        """Every slot empty, every page row null and every cache row and
        state zero, in place (an engine reset: stale rows of a poisoned
        cache would reach the attention's products)."""
        for t in (*cache_leaves(cache["layers"]), cache["len"],
                  *([cache["pages"]] if "pages" in cache else [])):
            t.zero_()
        return cache


def cache_leaves(layers) -> list:
    """The tensors of a decode cache's ``layers`` tree, in key order."""
    if isinstance(layers, torch.Tensor):
        return [layers]
    return [t for k in sorted(layers) for t in cache_leaves(layers[k])]


