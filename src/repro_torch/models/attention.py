"""GQA attention (+RoPE, sliding window, qk-norm): chunked flash-style
attention for prefill and ragged-chunk attention against a slotted KV
cache for decode, contiguous or paged; encdec's cross-attention against
the encoder's memory (a frozen per-slot cross cache in decode); and
DeepSeek's MLA, whose decode attends over the compressed cache with the
absorbed ``kv_up``.  Counterpart of ``repro.models.attention``.

Attention is plain PyTorch, as it is plain jnp in the reference (no model
there calls the Pallas flash kernel).  Scores and softmax run in f32.

On a mesh the ragged step (decode is its C = 1 case) runs on a rank's part
of the cache (:class:`~repro_torch.sharding.shard.DecodeLayout`, carried
by the step's :class:`StepPlan`): where the cache splits the KV heads over
"model" the rank attends over its own (:func:`repro_torch.models.tp.qkv`);
where it splits head_dim, q, k and v are gathered whole (the qk-norm and
rope need whole heads), each rank writes and reads its head_dim block, its
partial scores are summed over "model" (:func:`_score_sum`) and its block
of the context gathered back.  MLA's latent and rope key split their last
dim over "model": each rank writes its block and the step gathers the
latent whole (fewer collective bytes than summing every head's partial
scores).  Where the positions split over the data-parallel axes (batch 1
on long_500k), the rank owning a position writes it (a masked write) and
each rank attends over its positions at their absolute places; the ranks'
parts merge by log-sum-exp (:func:`_seq_softmax`, flash decoding across
ranks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.schemes import dense_view, linear_apply, linear_init
from repro_torch.sharding.rules import TP_AXIS
from repro_torch.sharding.shard import Mode, tp_of
from . import tp
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


def chunk_mask(qpos, s: int, window=None, start: int = 0):
    """[B, 1, 1, C, S] bool: cache position k is visible to query row i of
    slot b (k <= qpos[b, i], and inside the window when one is set).  The
    S positions are ``start..start + S - 1`` (a rank's part of a cache
    whose positions are split)."""
    kpos = start + torch.arange(s, device=qpos.device)
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


def _score_sum(scores, mesh):
    """Partial scores over this rank's head_dim block summed over
    "model" (f32)."""
    return mesh.all_reduce(scores, TP_AXIS, label="score_sum")


def _seq_softmax(scores, contract, layout):
    """``contract(softmax(scores))`` where the key positions (the last
    dim) are split over ``layout.seq``: each rank's exponentials against
    the global max, its contracted values and their sum merged over the
    axes (log-sum-exp; one f32 all-reduce of the max, one of the values
    and sums packed).  ``contract(p)`` keeps p's leading dims first."""
    mesh = layout.mesh
    m = mesh.all_reduce(scores.amax(dim=-1), layout.seq, op="max",
                        label="lse_merge")
    p = torch.exp(scores - m[..., None])
    packed = torch.cat([contract(p), p.sum(dim=-1)[..., None]], dim=-1)
    packed = mesh.all_reduce(packed, layout.seq, label="lse_merge")
    return packed[..., :-1] / packed[..., -1:]


def _softmax_values(scores, contract, layout):
    """``contract(softmax(scores))`` over the key positions: whole (no
    ``layout``, or one whose positions do not split) or split
    (:func:`_seq_softmax`)."""
    if layout is not None and layout.seq is not None:
        return _seq_softmax(scores, contract, layout)
    return contract(torch.softmax(scores, dim=-1))


def split_chunk_attention(q, k_cache, v_cache, mask, layout, scale):
    """:func:`chunk_attention` on a rank's part of the cache: q [B,C,H,Dq]
    (Dq this rank's head_dim block where ``layout.feature``), caches
    [B,S',KvH,D'] (S' its positions), ``mask`` its :func:`chunk_mask`,
    ``scale`` the whole head_dim's.  Returns [B,C,H,D'] f32: the context's
    head_dim block where the head_dim splits."""
    b, c, h, dq = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, c, kvh, h // kvh, dq)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    if layout.feature is not None:
        scores = _score_sum(scores, layout.mesh)
    scores = torch.where(mask, scores, NEG_INF)
    o = _softmax_values(scores, lambda p: torch.einsum(
        "bhgqk,bkhd->bhgqd", p, v_cache.to(torch.float32)), layout)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, h, -1)


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


def _rope_qk(p, q, k, cfg: AttnConfig, positions, theta=None, table=None):
    """q and k after the qk-norm (where the config has one) and rope."""
    theta = cfg.rope_theta if theta is None else theta
    if "qn" in p:
        q, k = rmsnorm(p["qn"], q), rmsnorm(p["kn"], k)
    if table is None:
        table = rope_table(positions, cfg.head_dim, theta)
    return rope(q, positions, table=table), rope(k, positions, table=table)


def _qkv(p, x, cfg: AttnConfig, positions, theta=None, table=None):
    b, s, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = linear_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = linear_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return (*_rope_qk(p, q, k, cfg, positions, theta, table), v)


def gqa_apply(p, x, cfg: AttnConfig, positions=None, window=None, theta=None,
              causal=True, chunk_q=256, chunk_k=1024, kv_len=None):
    """Prefill self-attention; returns (out, (k, v)).  ``window`` /
    ``theta`` override cfg (per-layer values).  On a shard (``wq``
    carries a tensor-parallel mode) the attention runs over this rank's
    query heads where it can, and ``wo`` gives the full output
    (:mod:`repro_torch.models.tp`)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    shard = tp_of(p["wq"])
    if shard is not None:
        q, k, v, heads = tp.qkv(p, x, cfg, shard.mesh)
        q, k = _rope_qk(p, q, k, cfg, positions, theta)
    else:
        q, k, v = _qkv(p, x, cfg, positions, theta)
    window = cfg.window if window is None else window
    o = flash_attention(q, k, v, causal=causal, window=window,
                        chunk_q=chunk_q, chunk_k=chunk_k, kv_len=kv_len)
    if shard is not None:
        return (tp.attn_output(p, o.reshape(b, s, -1), heads, shard.mesh),
                (k, v))
    out = linear_apply(p["wo"], o.reshape(b, s, -1))
    return out, (k, v)


def seq_insert_plan(cur_len, n_new, c: int, s: int, start: int):
    """:func:`insert_plan` into a rank's part of a cache whose positions
    are split: the part holds the ``s`` positions from ``start``, and a
    row is written only by the rank whose part holds its position (a
    masked write: no rank branches on the position).  A row's place in the
    part is its position modulo ``s``, so the C' <= s places of a slot are
    distinct on every rank."""
    c = min(c, s)
    i = torch.arange(c, device=cur_len.device)[None, :]
    pos = cur_len.to(torch.int64)[:, None] + i
    write = ((i < n_new.to(torch.int64)[:, None]) & (pos >= start)
             & (pos < start + s))
    rows = torch.arange(cur_len.shape[0], device=cur_len.device)[:, None]
    return rows, pos % s, write


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
    one and ``s`` is P * page_size.  On a mesh ``layout`` is the rank's
    :class:`~repro_torch.sharding.shard.DecodeLayout` and ``s`` its part's
    positions (from ``start``, where they split)."""

    def __init__(self, cur_len, n_new, c: int, s: int, head_dim: int,
                 pages=None, page_size: int = 0, layout=None):
        self.positions = (cur_len.to(torch.int64)[:, None]
                          + torch.arange(c, device=cur_len.device)[None, :])
        self.pages, self.layout = pages, layout
        self.start = layout.seq_start(s) if layout is not None else 0
        if layout is not None and pages is not None:
            raise NotImplementedError("a paged cache on a mesh: the "
                                      "reference has none")
        if layout is not None and layout.seq is not None:
            self.insert = seq_insert_plan(cur_len, n_new, c, s, self.start)
        elif pages is None:
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
            self._masks[key] = chunk_mask(self.positions, self.s, key,
                                          self.start)
        return self._masks[key]


def gqa_prefill_chunk(p, x, cache, cur_len, n_new, cfg: AttnConfig,
                      window=None, theta=None, plan=None, pages=None):
    """Ragged chunk step: x [B,C,d]; slot b consumes rows [:n_new[b]] at
    positions cur_len[b].., inserts their K/V into the slotted cache (in
    place) and attends causally against it.  C == 1 is decode.  On a mesh
    (``plan.layout``) the cache is this rank's part of it
    (:func:`_gqa_shard_qkv`, :func:`split_chunk_attention`).

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
    layout = plan.layout
    heads = False
    shard = tp_of(p["wq"])
    if layout is not None:
        q, k, v, heads = _gqa_shard_qkv(p, x, cfg, layout, shard,
                                        cache["k"].shape[2])
        q, k = _rope_qk(p, q, k, cfg, positions, theta,
                        table=plan.table(theta))
        if layout.feature is not None:
            q, k, v = (tp.rank_block(t, layout.mesh) for t in (q, k, v))
    else:
        q, k, v = _qkv(p, x, cfg, positions, theta, table=plan.table(theta))
    kc = _cache_insert(cache["k"], k, cur_len, n_new, pages, plan=plan.insert)
    vc = _cache_insert(cache["v"], v, cur_len, n_new, pages, plan=plan.insert)
    if layout is None:
        o = chunk_attention(q, _cache_view(kc, pages), _cache_view(vc, pages),
                            positions, window=window, mask=plan.mask(window))
    else:
        o = split_chunk_attention(q, kc, vc, plan.mask(window), layout,
                                  1.0 / math.sqrt(cfg.head_dim))
        if layout.feature is not None:
            o = layout.mesh.all_gather(o.contiguous(), TP_AXIS, o.dim() - 1,
                                       label="context")
    o = o.to(x.dtype).reshape(b, c, -1)
    out = (linear_apply(p["wo"], o) if shard is None
           else tp.attn_output(p, o, heads, shard.mesh))
    return out, {"k": kc, "v": vc}


def _gqa_shard_qkv(p, x, cfg: AttnConfig, layout, shard, cache_heads: int):
    """q, k, v ``[B, C, heads, hd]`` of a rank's ragged step, before the
    norms and rope, and whether q holds this rank's query heads: where
    the cache splits the KV heads over "model", :func:`tp.qkv`'s (which
    must give the rank ``cache_heads`` of them, its own block); else whole
    (gathered over "model", each rank then takes its head_dim block where
    the cache splits head_dim)."""
    b, c, _ = x.shape
    if layout.heads is not None:
        q, k, v, heads = tp.qkv(p, x, cfg, shard.mesh)
        if not heads or k.shape[2] != cache_heads:
            raise NotImplementedError(
                f"the cache holds {cache_heads} KV heads a rank, the "
                f"tensor-parallel attention reads {k.shape[2]}: no decode "
                f"step holds that layout")
        return q, k, v, True
    if shard is None:
        lin = {n: linear_apply(p[n], x) for n in ("wq", "wk", "wv")}
    else:
        lin = {n: tp.full_output(p[n], x, shard.mesh)
               for n in ("wq", "wk", "wv")}
    q, k, v = (lin[n].reshape(b, c, -1, cfg.head_dim)
               for n in ("wq", "wk", "wv"))
    return q, k, v, False


def gqa_init_cache(batch: int, seq: int, cfg: AttnConfig,
                   dtype=torch.bfloat16, device="cuda"):
    """Slotted KV cache: each of the ``batch`` slots owns a private [seq]
    region (its valid prefix is the caller's ``len`` vector)."""
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# cross-attention (enc-dec)
# ---------------------------------------------------------------------------


def cross_init(generator, cfg: AttnConfig, pol, device="cuda") \
        -> nn.ModuleDict:
    return gqa_init(generator, cfg, pol, device)


def cross_kv(p, mem, cfg: AttnConfig):
    """K/V of the encoder memory ``mem`` [B, Ss, d] -> each [B, Ss, KvH,
    hd] (computed once and reused by every decode step)."""
    b, s, _ = mem.shape
    k = linear_apply(p["wk"], mem).reshape(b, s, cfg.n_kv_heads,
                                           cfg.head_dim)
    v = linear_apply(p["wv"], mem).reshape(b, s, cfg.n_kv_heads,
                                           cfg.head_dim)
    return k, v


def cross_apply(p, x, k_mem, v_mem, cfg: AttnConfig, chunk_q=256,
                chunk_k=1024):
    """No rope, no causality: every query attends to the whole memory.  A
    single-token call is :func:`cross_chunk` over the whole memory (one
    copy of the decode math, as in the reference)."""
    b, s, _ = x.shape
    if s == 1:
        return cross_chunk(p, x, k_mem, v_mem, torch.full(
            (b,), k_mem.shape[1], dtype=torch.int32, device=x.device), cfg)
    q = linear_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    o = flash_attention(q, k_mem, v_mem, causal=False, chunk_q=chunk_q,
                        chunk_k=chunk_k)
    return linear_apply(p["wo"], o.reshape(b, s, -1))


def cross_chunk(p, x, k_mem, v_mem, mem_len, cfg: AttnConfig):
    """Ragged cross-attention against the per-slot frozen cross cache: x
    [B, C, d], caches [B, Ss, KvH, hd], ``mem_len`` [B] the valid frames
    of each slot (a tensor: a captured step reads it at its address).
    Every row of slot b attends to frames < mem_len[b], whatever its
    decode position.  ``mem_len`` 0 (a src-less slot) masks every frame:
    the finite ``NEG_INF`` makes that a uniform average over the slot's
    zeroed cross cache, a zero context, as the reference's."""
    b, c, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(b, c, cfg.n_heads, cfg.head_dim)
    mem_pos = (mem_len.to(torch.int64) - 1)[:, None].expand(b, c)
    o = chunk_attention(q, k_mem, v_mem, mem_pos)
    return linear_apply(p["wo"], o.reshape(b, c, -1))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 multi-head latent attention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4


def mla_init(generator, cfg: MLAConfig, pol, device="cuda") -> nn.ModuleDict:
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return nn.ModuleDict({
        "q_down": linear_init(generator, cfg.d_model, cfg.q_lora_rank,
                              pol.at("q_down"), device),
        "q_up": linear_init(generator, cfg.q_lora_rank, h * qk,
                            pol.at("q_up"), device),
        "kv_down": linear_init(generator, cfg.d_model,
                               cfg.kv_lora_rank + cfg.qk_rope_dim,
                               pol.at("kv_down"), device),
        "kv_up": linear_init(generator, cfg.kv_lora_rank,
                             h * (cfg.qk_nope_dim + cfg.v_head_dim),
                             pol.at("kv_up"), device),
        "wo": linear_init(generator, h * cfg.v_head_dim, cfg.d_model,
                          pol.at("wo"), device),
        "qn": rmsnorm_init(cfg.q_lora_rank, device=device),
        "kvn": rmsnorm_init(cfg.kv_lora_rank, device=device),
    })


def _mla_q(p, x, cfg: MLAConfig, positions, table=None):
    b, s, _ = x.shape
    qc = rmsnorm(p["qn"], linear_apply(p["q_down"], x))
    q = linear_apply(p["q_up"], qc).reshape(
        b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta, table=table)


def _mla_ckv(p, x, cfg: MLAConfig, positions, table=None):
    """The compressed latent [B,S,rank] (normed) and the shared rope key
    [B,S,rope] of ``x``: what the decode cache holds."""
    ckv = linear_apply(p["kv_down"], x)
    c, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c = rmsnorm(p["kvn"], c)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta,
                  table=table)[:, :, 0]
    return c, k_rope


def _mla_apply_tp(p, x, cfg: MLAConfig, positions, mesh):
    """:func:`mla_apply` on a shard (the reference's COL / ROW roles):
    ``q_down`` and ``kv_down`` gathered (the latent norms run on the whole
    latent), ``q_up`` and ``kv_up`` give this rank's heads where they are
    ``col`` and the heads split over "model" (else every head on every
    rank), ``wo`` the full output (:func:`_mla_shard_q_ckv`).  The cache
    is this rank's block of the latent and the rope key over "model"
    (``cache_spec_tree``'s)."""
    b, s, _ = x.shape
    q_nope, q_rope, c, k_rope, heads = _mla_shard_q_ckv(
        p, x, cfg, positions, None, mesh)
    if heads:
        kv = tp.apply_linear(p["kv_up"], tp.copy_to(c, mesh))
        kr = tp.copy_to(k_rope, mesh)
    else:
        kv = tp.full_output(p["kv_up"], c, mesh)
        kr = k_rope
    hl = q_nope.shape[2]
    kv = kv.reshape(b, s, hl, cfg.qk_nope_dim + cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :cfg.qk_nope_dim], kr[:, :, None, :].expand(
        b, s, hl, cfg.qk_rope_dim)], dim=-1)
    o = flash_attention(q, k, kv[..., cfg.qk_nope_dim:], causal=True)
    out = tp.attn_output(p, o.reshape(b, s, -1), heads, mesh)
    return out, (tp.rank_block(c, mesh), tp.rank_block(k_rope, mesh))


def _mla_shard_q_ckv(p, x, cfg: MLAConfig, positions, table, mesh):
    """A shard's query (nope [B,C,h',nope], roped [B,C,h',rope]), the new
    latent [B,C,rank] (normed) and rope key [B,C,rope] whole, and whether
    the h' heads are this rank's (``q_up`` ``col`` and the heads split
    over "model"; else every head)."""
    b, c, _ = x.shape
    h, t = cfg.n_heads, mesh.size(TP_AXIS)
    qc = rmsnorm(p["qn"], tp.full_output(p["q_down"], x, mesh))
    ckv = tp.full_output(p["kv_down"], x, mesh)
    c_new = rmsnorm(p["kvn"], ckv[..., :cfg.kv_lora_rank])
    kr_new = rope(ckv[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                  cfg.rope_theta, table=table)[:, :, 0]
    heads = h % t == 0 and all(tp_of(p[n]).mode is Mode.COL
                               for n in ("q_up", "kv_up"))
    q = (tp.apply_linear(p["q_up"], tp.copy_to(qc, mesh)) if heads
         else tp.full_output(p["q_up"], qc, mesh))
    q = q.reshape(b, c, -1, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_rope = rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta,
                  table=table)
    return q[..., :cfg.qk_nope_dim], q_rope, c_new, kr_new, heads


def mla_apply(p, x, cfg: MLAConfig, positions=None):
    """Training / prefill: per-head K/V materialised through ``kv_up``,
    flash-style attention.  Returns (out, (c, k_rope)), the compressed
    cache of ``x`` (on a shard, :func:`_mla_apply_tp`)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    shard = tp_of(p["q_up"])
    if shard is not None:
        return _mla_apply_tp(p, x, cfg, positions, shard.mesh)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c, k_rope = _mla_ckv(p, x, cfg, positions)
    kv = linear_apply(p["kv_up"], c).reshape(
        b, s, h, cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    o = flash_attention(q, k, v, causal=True)
    out = linear_apply(p["wo"], o.reshape(b, s, -1))
    return out, (c, k_rope)


def mla_chunk_attention(q_c, q_rope, c_cache, kr_cache, qpos, *, scale,
                        mask=None, layout=None):
    """Absorbed ragged-chunk attention over the slotted compressed cache,
    in f32: ``q_c`` [B,C,H,rank] (the nope query absorbed through W_uk),
    ``q_rope`` [B,C,H,rope], caches [B,S,rank] and [B,S,rope], ``qpos``
    [B,C] (row i of slot b attends to positions <= qpos[b, i]).  Returns
    the context in the rank space, [B,C,H,rank] f32.  Masked entries hit
    exp(NEG_INF) == 0 exactly; a fully masked row (qpos < 0, an idle
    slot) is a uniform average: garbage, but finite.  ``mask`` is a
    precomputed :func:`chunk_mask` for these arguments; with a ``layout``
    whose positions split, the caches are this rank's positions and the
    softmax merges over the ranks (:func:`_seq_softmax`)."""
    s_c = torch.einsum("bqhr,bkr->bhqk", q_c.to(torch.float32),
                       c_cache.to(torch.float32))
    s_r = torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                       kr_cache.to(torch.float32))
    scores = (s_c + s_r) * scale
    if mask is None:
        mask = chunk_mask(qpos, c_cache.shape[1])
    scores = torch.where(mask[:, 0], scores, NEG_INF)   # [B, 1, C, S]
    ctx = _softmax_values(scores, lambda p: torch.einsum(
        "bhqk,bkr->bhqr", p, c_cache.to(torch.float32)), layout)
    return ctx.permute(0, 2, 1, 3)


def mla_prefill_chunk(p, x, cache, cur_len, n_new, cfg: MLAConfig,
                      w_kv=None, plan=None, pages=None):
    """Ragged chunk step through MLA: x [B,C,d]; slot b consumes rows
    [:n_new[b]] at positions cur_len[b].., inserts their latent and rope
    key into the slotted (or, with ``pages``, paged) cache, in place, and
    attends in the rank space: the nope query absorbed through W_uk, the
    context up-projected through W_uv, both in f32.  C == 1 is decode.

    ``w_kv`` is the layer's precomputed (W_uk [rank,H,nope], W_uv
    [rank,H,vdim]) (:func:`kv_up_split`, which runs here when it is None);
    ``plan`` the step's :class:`StepPlan` (its head_dim the rope dim).

    On a mesh (``plan.layout``) the cache is this rank's part: where it
    splits the latent and rope key over "model" the rank writes its block
    and the step gathers both whole; the rank's heads (``q_up`` and
    ``kv_up`` ``col``: ``w_kv`` of the shard's ``kv_up``) attend and
    ``wo`` gives the full output."""
    b, c, _ = x.shape
    if plan is None:
        ps = cache["c"].shape[1]
        s = ps if pages is None else pages.shape[1] * ps
        plan = StepPlan(cur_len, n_new, c, s, cfg.qk_rope_dim, pages=pages,
                        page_size=ps)
    pages, layout = plan.pages, plan.layout
    positions = plan.positions
    table = plan.table(cfg.rope_theta)
    shard = tp_of(p["q_up"])
    heads = False
    if shard is not None:
        q_nope, q_rope, c_new, kr_new, heads = _mla_shard_q_ckv(
            p, x, cfg, positions, table, shard.mesh)
    else:
        q_nope, q_rope = _mla_q(p, x, cfg, positions, table=table)
        c_new, kr_new = _mla_ckv(p, x, cfg, positions, table=table)
    if layout is not None and layout.feature is not None:
        c_new, kr_new = (tp.rank_block(t, layout.mesh)
                         for t in (c_new, kr_new))
    cc = _cache_insert(cache["c"], c_new, cur_len, n_new, pages,
                       plan=plan.insert)
    krc = _cache_insert(cache["kr"], kr_new, cur_len, n_new, pages,
                        plan=plan.insert)
    c_all, kr_all = _cache_view(cc, pages), _cache_view(krc, pages)
    if layout is not None and layout.feature is not None:
        c_all, kr_all = (layout.mesh.all_gather(t, TP_AXIS, t.dim() - 1,
                                                label="latent_gather")
                         for t in (c_all, kr_all))
    w_uk, w_uv = w_kv if w_kv is not None else kv_up_split(p, cfg, x.dtype)
    q_c = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32),
                       w_uk.to(torch.float32))
    ctx_c = mla_chunk_attention(
        q_c, q_rope, c_all, kr_all, positions,
        scale=1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim),
        mask=plan.mask(0), layout=layout)
    o = torch.einsum("bqhr,rhv->bqhv", ctx_c, w_uv.to(torch.float32))
    o = o.reshape(b, c, -1).to(x.dtype)
    if shard is None:
        return linear_apply(p["wo"], o), {"c": cc, "kr": krc}
    return tp.attn_output(p, o, heads, shard.mesh), {"c": cc, "kr": krc}


def mla_decode(p, x, cache, cur_len, cfg: MLAConfig, w_kv=None):
    """Absorbed one-token decode: the C=1 always-active case of
    :func:`mla_prefill_chunk`."""
    return mla_prefill_chunk(p, x, cache, cur_len, torch.ones_like(cur_len),
                             cfg, w_kv=w_kv)


def kv_up_split(p, cfg: MLAConfig, dtype):
    """The effective (adapter-included) ``kv_up`` weight, dequantised in
    ``dtype``, split into its K half W_uk [rank,H,nope] and V half W_uv
    [rank,H,vdim].  On a shard H is the heads of this rank's ``kv_up``
    columns (a ``whole`` linear's gathered: every head)."""
    lp = p["kv_up"]
    shard = tp_of(lp)
    w = dense_view(shard.whole(lp) if shard is not None else lp, dtype=dtype)
    w = w.reshape(cfg.kv_lora_rank, -1, cfg.qk_nope_dim + cfg.v_head_dim)
    return w[..., :cfg.qk_nope_dim], w[..., cfg.qk_nope_dim:]


def mla_init_cache(batch: int, seq: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device="cuda"):
    return {"c": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype,
                              device=device)}
