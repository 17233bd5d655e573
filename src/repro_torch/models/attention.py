"""GQA attention (+RoPE, sliding window, qk-norm): chunked flash-style
attention for prefill and ragged-chunk attention against a slotted KV
cache for decode, contiguous or paged.  Counterpart of the GQA part of
``repro.models.attention``.

Attention is plain PyTorch, as it is plain jnp in the reference (no model
there calls the Pallas flash kernel).  Scores and softmax run in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.schemes import linear_apply, linear_init
from .common import rmsnorm, rmsnorm_init, rope, rope_table

NEG_INF = -1e30
NULL_PAGE = 0  # repro_torch.serving.paging.NULL_PAGE


# ---------------------------------------------------------------------------
# chunked (flash-style) attention core
# ---------------------------------------------------------------------------


def _mask(qpos, kpos, causal: bool, window):
    """window: None or an int (0 = full attention, which lets a per-layer
    window drive gemma3's local:global pattern)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    chunk_q=256, chunk_k=1024, scale=None, kv_len=None):
    """q: [B,Sq,H,Dq]  k: [B,Sk,KvH,Dq]  v: [B,Sk,KvH,Dv] -> [B,Sq,H,Dv].

    H must be a multiple of KvH (GQA); memory O(chunk_q * chunk_k) scores
    per head.  ``kv_len`` ([B], optional) masks keys at positions >=
    kv_len[b]."""
    b, sq, h, dq = q.shape
    _, sk, kvh, _ = k.shape
    dv = v.shape[-1]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dq)
    dev = q.device

    chunk_q = min(chunk_q, sq)
    chunk_k = min(chunk_k, sk)
    assert sq % chunk_q == 0 and sk % chunk_k == 0, (sq, chunk_q, sk, chunk_k)
    nq, nk = sq // chunk_q, sk // chunk_k

    qc = q.reshape(b, nq, chunk_q, kvh, g, dq).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nk, chunk_k, kvh, dq).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, chunk_k, kvh, dv).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        qpos = q_offset + qi * chunk_q + torch.arange(chunk_q, device=dev)
        q_blk = qc[qi].to(torch.float32)
        m_run = torch.full((b, kvh, g, chunk_q), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((b, kvh, g, chunk_q), dtype=torch.float32,
                            device=dev)
        acc = torch.zeros((b, kvh, g, chunk_q, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kpos = ki * chunk_k + torch.arange(chunk_k, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk,
                             kc[ki].to(torch.float32)) * scale
            msk = _mask(qpos, kpos, causal, window)
            s = torch.where(msk[None, None, None], s, NEG_INF)
            if kv_len is not None:
                km = kpos[None, :] < kv_len[:, None]          # [B, ck]
                s = torch.where(km[:, None, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vc[ki].to(torch.float32))
            m_run = m_new
        outs.append(acc / l_run[..., None].clamp_min(1e-37))
    out = torch.stack(outs)  # [nq, B, KvH, G, cq, Dv]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def chunk_mask(qpos, s: int, window=None):
    """[B, 1, 1, C, S] bool: cache position k is visible to query row i of
    slot b (k <= qpos[b, i], and inside the window when one is set)."""
    kpos = torch.arange(s, device=qpos.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # [B, C, S]
    if window:
        valid &= kpos[None, None, :] > (qpos[:, :, None] - window)
    return valid[:, None, None, :, :]


def chunk_attention(q, k_cache, v_cache, qpos, *, window=None, mask=None):
    """Ragged-chunk attention against a slotted cache.

    q: [B,C,H,Dq]; caches: [B,S,KvH,D*]; qpos: [B,C] absolute position of
    each query row (row i of slot b attends to cache positions <=
    qpos[b, i]).  Masked entries hit exp(NEG_INF) == 0 exactly, so results
    do not depend on the cache capacity or on stale rows past qpos.
    ``mask`` is a precomputed :func:`chunk_mask` for these arguments."""
    b, c, h, dq = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    qg = q.reshape(b, c, kvh, g, dq)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / math.sqrt(dq)
    if mask is None:
        mask = chunk_mask(qpos, s, window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, c, h, -1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, window=None):
    """One-token attention. q: [B,1,H,Dq]; ``cur_len`` counts valid cache
    entries including the just-inserted token."""
    return chunk_attention(q, k_cache, v_cache, (cur_len - 1)[:, None],
                           window=window)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    window: Optional[int] = None  # sliding window; None = full causal
    qk_norm: bool = False


def gqa_init(generator, cfg: AttnConfig, pol, device="cuda") -> nn.ModuleDict:
    h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = nn.ModuleDict({
        "wq": linear_init(generator, d, h * hd, pol.at("wq"), device),
        "wk": linear_init(generator, d, kvh * hd, pol.at("wk"), device),
        "wv": linear_init(generator, d, kvh * hd, pol.at("wv"), device),
        "wo": linear_init(generator, h * hd, d, pol.at("wo"), device),
    })
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(hd, device=device)
        p["kn"] = rmsnorm_init(hd, device=device)
    return p


def _qkv(p, x, cfg: AttnConfig, positions, theta=None, table=None):
    b, s, _ = x.shape
    theta = cfg.rope_theta if theta is None else theta
    q = linear_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = linear_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = linear_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if "qn" in p:
        q, k = rmsnorm(p["qn"], q), rmsnorm(p["kn"], k)
    if table is None:
        table = rope_table(positions, cfg.head_dim, theta)
    return rope(q, positions, table=table), rope(k, positions, table=table), v


def gqa_apply(p, x, cfg: AttnConfig, positions=None, window=None, theta=None,
              causal=True, chunk_q=256, chunk_k=1024, kv_len=None):
    """Prefill self-attention; returns (out, (k, v)).  ``window`` /
    ``theta`` override cfg (per-layer values)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions, theta)
    window = cfg.window if window is None else window
    o = flash_attention(q, k, v, causal=causal, window=window,
                        chunk_q=chunk_q, chunk_k=chunk_k, kv_len=kv_len)
    out = linear_apply(p["wo"], o.reshape(b, s, -1))
    return out, (k, v)


def insert_plan(cur_len, n_new, c: int, s: int):
    """Where a ragged chunk of ``c`` rows lands in a cache of capacity
    ``s``: (slot index [B, 1], position [B, C'] taken modulo ``s``, write
    [B, C'] bool), for the first C' = min(c, s) rows (a row past the
    capacity is never written).  Within a slot the C' positions are
    distinct, so one indexed write never hits a position twice.  Shared by
    every layer's K and V inserts of one step."""
    c = min(c, s)
    i = torch.arange(c, device=cur_len.device)[None, :]
    pos = cur_len.to(torch.int64)[:, None] + i
    write = (i < n_new.to(torch.int64)[:, None]) & (pos < s)
    rows = torch.arange(cur_len.shape[0], device=cur_len.device)[:, None]
    return rows, pos % s, write


def _insert_tokens(cache, new, cur_len, n_new, plan=None):
    """Ragged multi-token insert, in place: write new[b, i] at position
    cur_len[b] + i for i < n_new[b]; rows i >= n_new[b], and positions past
    the capacity, are dropped.  cache [B,S,...], new [B,C,...].

    One indexed write for the whole chunk, with no host synchronisation:
    a dropped row writes back the value its position holds.  ``plan`` is
    a precomputed :func:`insert_plan`."""
    rows, pos, write = plan if plan is not None else insert_plan(
        cur_len, n_new, new.shape[1], cache.shape[1])
    new = new[:, :pos.shape[1]].to(cache.dtype)
    keep = write.reshape(write.shape + (1,) * (cache.dim() - 2))
    cache[rows, pos] = torch.where(keep, new, cache[rows, pos])
    return cache


def paged_view(pool, pages):
    """A slot-contiguous view of a paged cache pool, gathered.

    pool: [n_pages, ps, ...]; pages: [B, P] page indices (entry k of slot b
    maps positions [k*ps, (k+1)*ps); unmapped entries point at the null
    page).  Returns [B, P*ps, ...], the slotted [B, S, ...] cache the
    attention expects.  Null-page rows surface only at positions past the
    slot's allocation, which the position mask excludes."""
    b, p = pages.shape
    ps = pool.shape[1]
    return pool[pages.to(torch.int64)].reshape((b, p * ps) + pool.shape[2:])


def paged_insert_plan(cur_len, n_new, c: int, pages, page_size: int):
    """Where a ragged chunk of ``c`` rows lands in a paged pool: (page
    [B, C], offset [B, C], write [B, C] bool).  Row i of slot b goes to
    position cur_len[b] + i, i.e. page ``pages[b, pos // page_size]`` at
    offset ``pos % page_size``; rows i >= n_new[b] go to the null page at
    offset 0.  Live slots hold disjoint pages past their shared (read-only)
    prefix, so written rows never collide across slots."""
    i = torch.arange(c, device=cur_len.device)[None, :]
    pos = cur_len.to(torch.int64)[:, None] + i
    write = i < n_new.to(torch.int64)[:, None]
    col = (pos // page_size).clamp(0, pages.shape[1] - 1)
    page = torch.gather(pages.to(torch.int64), 1, col)
    return (torch.where(write, page, NULL_PAGE),
            torch.where(write, pos % page_size, 0), write)


def _insert_tokens_paged(pool, new, cur_len, n_new, pages, plan=None):
    """Paged counterpart of :func:`_insert_tokens`, in place: new[b, i]
    goes into the pool page holding position cur_len[b] + i (i <
    n_new[b]).  pool [n_pages, ps, ...], new [B, C, ...], pages [B, P].
    A dropped row writes back the value the null page's first row holds,
    so the null page never changes.  ``plan`` is a precomputed
    :func:`paged_insert_plan`."""
    page, off, write = plan if plan is not None else paged_insert_plan(
        cur_len, n_new, new.shape[1], pages, pool.shape[1])
    keep = write.reshape(write.shape + (1,) * (pool.dim() - 2))
    pool[page, off] = torch.where(keep, new.to(pool.dtype), pool[page, off])
    return pool


def _cache_insert(leaf, new, cur_len, n_new, pages, plan=None):
    """Insert into a contiguous slotted leaf when ``pages`` is None, into a
    paged pool otherwise."""
    if pages is None:
        return _insert_tokens(leaf, new, cur_len, n_new, plan=plan)
    return _insert_tokens_paged(leaf, new, cur_len, n_new, pages, plan=plan)


def _cache_view(leaf, pages):
    """The leaf itself when contiguous, its gathered view when paged."""
    return leaf if pages is None else paged_view(leaf, pages)


class StepPlan:
    """The tensors one ragged step shares across its layers: positions,
    the cache-insert plan, and (memoised per theta / window) rotary tables
    and attention masks.  Building them once per step rather than once per
    layer keeps the host's per-step operation count down.

    ``s`` is each slot's capacity; with ``pages`` ([B, P] page rows of a
    paged cache of ``page_size``-token pages) the insert plan is the paged
    one and ``s`` is P * page_size."""

    def __init__(self, cur_len, n_new, c: int, s: int, head_dim: int,
                 pages=None, page_size: int = 0):
        self.positions = (cur_len.to(torch.int64)[:, None]
                          + torch.arange(c, device=cur_len.device)[None, :])
        self.pages = pages
        if pages is None:
            self.insert = insert_plan(cur_len, n_new, c, s)
        else:
            self.insert = paged_insert_plan(cur_len, n_new, c, pages,
                                            page_size)
        self.s, self.head_dim = s, head_dim
        self._tables, self._masks = {}, {}

    def table(self, theta):
        if theta not in self._tables:
            self._tables[theta] = rope_table(self.positions, self.head_dim,
                                             theta)
        return self._tables[theta]

    def mask(self, window):
        key = window or 0
        if key not in self._masks:
            self._masks[key] = chunk_mask(self.positions, self.s, key)
        return self._masks[key]


def gqa_prefill_chunk(p, x, cache, cur_len, n_new, cfg: AttnConfig,
                      window=None, theta=None, plan=None, pages=None):
    """Ragged chunk step: x [B,C,d]; slot b consumes rows [:n_new[b]] at
    positions cur_len[b].., inserts their K/V into the slotted cache (in
    place) and attends causally against it.  C == 1 is decode.

    ``pages`` ([B, P] int32) switches the cache leaves from per-slot
    [B, S, ...] to paged pools [n_pages, ps, ...]: inserts go through the
    page rows and the attention runs on the gathered per-slot view.
    ``plan`` is the step's :class:`StepPlan` (built here from ``pages``
    when not given; a given plan carries its own page rows)."""
    b, c, _ = x.shape
    if plan is None:
        ps = cache["k"].shape[1]
        s = ps if pages is None else pages.shape[1] * ps
        plan = StepPlan(cur_len, n_new, c, s, cfg.head_dim, pages=pages,
                        page_size=ps)
    pages = plan.pages
    theta = cfg.rope_theta if theta is None else theta
    window = cfg.window if window is None else window
    positions = plan.positions
    q, k, v = _qkv(p, x, cfg, positions, theta, table=plan.table(theta))
    kc = _cache_insert(cache["k"], k, cur_len, n_new, pages, plan=plan.insert)
    vc = _cache_insert(cache["v"], v, cur_len, n_new, pages, plan=plan.insert)
    o = chunk_attention(q, _cache_view(kc, pages), _cache_view(vc, pages),
                        positions, window=window, mask=plan.mask(window))
    out = linear_apply(p["wo"], o.reshape(b, c, -1))
    return out, {"k": kc, "v": vc}


def gqa_init_cache(batch: int, seq: int, cfg: AttnConfig,
                   dtype=torch.bfloat16, device="cuda"):
    """Slotted KV cache: each of the ``batch`` slots owns a private [seq]
    region (its valid prefix is the caller's ``len`` vector)."""
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
