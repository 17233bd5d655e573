"""Mixture-of-experts FFN with capacity-based dispatch (counterpart of
``repro.models.moe``).

Routing styles:

  * ``"softmax"`` -- Mixtral: softmax over the experts, top-k,
    renormalised;
  * ``"sigmoid"`` -- DeepSeek-V3: sigmoid affinities plus a per-expert
    ``bias`` used only to select (aux-loss-free balancing); the gates are
    the renormalised sigmoid scores of the selected experts.  Shared
    experts run densely beside the routed ones.

Dispatch: an assignment's position within its expert is its rank in a
stable argsort of the expert ids (no ``[T*k, E]`` one-hot); token ids go
into an ``[E, C]`` slot table, C = ceil(k T / E * capacity_factor),
whose overflow lands in an extra row and column that are sliced off (the
reference's ``mode="drop"``), and the expert buffer ``[E, C, d]`` is a
gather from the tokens plus a zero pad row (the "no token" id ``T``).
Every shape depends on T alone and nothing reads a value back to the
host, so a step through this FFN is capturable as a CUDA graph.  Finite
capacity makes a token's routing depend on the rows before it in the
batch, padding rows included, as in the reference.

Training: the output is differentiable in x, the gates and every expert
adapter, and the aux loss in the router's softmax (the counts carry no
gradient, the router is frozen).  The two gathers (dispatch into the
expert buffer, combine out of it) have backwards written as gathers too
(:class:`_Dispatch`, :class:`_Combine`): a token's gradient is the fixed-
order sum over its <= top_k slots, read through the slot table and its
inverse, where autograd's own backward of an indexed read is a
scatter-add (atomic on CUDA, so a gradient could differ from run to run
in its last bits).  The forward is the same gather either way.

Each expert's gate, up and down are linears of the policy (paths
``moe/gate``, ``moe/up``, ``moe/down``) applied to that expert's
``[C, d]`` slice: the reference vmaps ``linear_apply`` over the experts,
here a loop calls it, so on the card every quantized expert linear is one
launch of the port's kernels at M = C.  The router is an fp linear tagged
exempt (conversion never quantizes it), computed in f32 outside any
kernel, as in the reference.

On a mesh (a shard's layer carries
:class:`~repro_torch.sharding.shard.ExpertShard` as ``p.ep``) the layer
computes the one-device function of the global batch.  The tokens are
split over the data-parallel axes (:func:`rows_over`); each routing
group is routed over its global ``T = B * S``: the expert ids are
gathered over those axes, so every rank knows the global slot table
(capacity ``ceil(k T / E * cf)``, positions by one stable rank over the
global order) and the kept set is the one device's, and the aux term's
means and counts are the global batch's (each rank adds its share of
it to its loss).  A rank computes its experts' slots: every slot of its
experts where the expert dim splits over the data-parallel axes and
"model" (full expert parallelism), else a block of the capacity over the
data-parallel axes (experts split over "model" alone, or every expert
tensor-parallel inside, its gate and up ``col`` and its down ``row``).
The token rows reach those slots by :func:`repro_torch.models.tp.dispatch`
and come back by :func:`~repro_torch.models.tp.combine`; where experts
sit on other "model" ranks the combined rows are partial sums, reduced
over "model".  The router is ``col`` where E divides "model" (its scores
gathered before top-k), else replicated.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.schemes import linear_apply, linear_init
from repro_torch.sharding.shard import Mode, tp_of
from . import tp
from .common import act_fn
from .mlp import mlp_apply, mlp_init


class MoEParams(nn.Module):
    """One layer's MoE parameters: ``router`` (an exempt fp linear
    ``[d, E]``), the expert linears ``gate``, ``up`` and ``down`` (a
    ``ModuleList`` of E each), buffer ``bias`` ``[E]`` f32 under sigmoid
    routing (else None) and ``shared`` (the shared experts' MLP, or
    None)."""

    def __init__(self, router, gate, up, down,
                 bias: Optional[torch.Tensor] = None,
                 shared: Optional[nn.Module] = None):
        super().__init__()
        self.router = router
        self.gate = nn.ModuleList(gate)
        self.up = nn.ModuleList(up)
        self.down = nn.ModuleList(down)
        self.register_buffer("bias", bias)
        self.add_module("shared", shared)


def moe_init(generator, d_model: int, d_ff: int, n_experts: int, pol,
             n_shared: int = 0, shared_d_ff: int = 0,
             routing: str = "softmax", device="cuda") -> MoEParams:
    def experts(name, d_in, d_out):
        return [linear_init(generator, d_in, d_out, pol.at(name), device)
                for _ in range(n_experts)]

    router = linear_init(generator, d_model, n_experts, pol.at("router"),
                         device, exempt=True)
    gate = experts("gate", d_model, d_ff)
    up = experts("up", d_model, d_ff)
    down = experts("down", d_ff, d_model)
    bias = (torch.zeros((n_experts,), dtype=torch.float32, device=device)
            if routing == "sigmoid" else None)
    shared = (mlp_init(generator, d_model, shared_d_ff * n_shared,
                       pol.at("shared"), True, device) if n_shared else None)
    return MoEParams(router, gate, up, down, bias, shared)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

_RECORDERS: List[list] = []
# the mesh axes a shard's rows are split over (a stack: the innermost
# holds); in any thread, as a remat recompute runs in the backward's
_ROWS: List[tuple] = []
# per thread: the remat recompute runs in the backward's thread
_SUSPENDED = threading.local()
_CHOOSERS: List = []


@contextlib.contextmanager
def record_routing():
    """Collect the routing of every :func:`moe_apply` call made in the
    context, in any thread of the process: yields a list that gains, per
    call in call order (so per layer within a forward), ``{"idx": [B, S,
    k] int64, "keep": [B, S, k] bool}`` on the call's device (``keep``
    False where capacity dropped the assignment).  For eager runs: a
    replayed CUDA graph records nothing, and neither does the recompute
    of a rematerialised block in the backward
    (:func:`suspend_recording`), so a training step records each layer
    once."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


@contextlib.contextmanager
def suspend_recording():
    """:func:`record_routing` records nothing from this thread inside this
    context (the remat recompute of ``repro_torch.models.lm`` runs in
    it)."""
    depth = getattr(_SUSPENDED, "depth", 0)
    _SUSPENDED.depth = depth + 1
    try:
        yield
    finally:
        _SUSPENDED.depth = depth


@contextlib.contextmanager
def choose_experts(chooser):
    """Every :func:`moe_apply` call made in the context, in any thread (a
    remat recompute must choose as its forward did), routes each token to
    the experts ``chooser(p, idx, scores)`` returns, ``[T, k]`` int64, in
    place of its own top-k ``idx``; ``p`` is the layer's parameters and
    ``scores`` its router's probabilities ``[T, E]`` (the sigmoid scores
    under sigmoid routing), detached.  Gates, capacity and aux follow the
    chosen ids as they follow the top-k.  For measurement: two runs that
    break a near tie differently held to one routing."""
    _CHOOSERS.append(chooser)
    try:
        yield
    finally:
        _CHOOSERS.remove(chooser)


@contextlib.contextmanager
def rows_over(axes):
    """A shard's MoE layers take the rows of their input as this rank's
    block of the global batch over the mesh ``axes`` (() where every rank
    holds the whole batch) in the context; outside any, the mesh's
    data-parallel axes."""
    _ROWS.append(tuple(axes))
    try:
        yield
    finally:
        _ROWS.pop()


def _select(p: MoEParams, logits, top_k: int, routing: str):
    """(router probabilities [T, E], expert ids [T, k], gates [T, k]) of
    router logits f32 [T, E]."""
    probs = torch.softmax(logits, dim=-1)
    if routing == "softmax":
        scores = select = probs
    else:
        scores = torch.sigmoid(logits)
        select = scores + p.bias[None, :]
    idx = torch.topk(select, top_k, dim=-1)[1]
    for chooser in _CHOOSERS:
        idx = chooser(p, idx, scores.detach())
    gates = torch.gather(scores, -1, idx)
    return probs, idx, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def _expert_share(idx, n_experts: int):
    """Each expert's share of the assignments ``idx`` (no gradient)."""
    ce = torch.zeros((n_experts,), dtype=torch.float32, device=idx.device)
    ce = ce.index_add(0, idx.reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.float32,
                                 device=idx.device))
    return ce / ce.sum().clamp_min(1.0)


def _route(p: MoEParams, x2, n_experts: int, top_k: int, routing: str):
    """Router logits in f32 -> (gates [T, k] in x's dtype, expert ids
    [T, k], the Switch load-balance aux loss)."""
    logits = linear_apply(p.router, x2.to(torch.float32))  # [T, E]
    probs, idx, gates = _select(p, logits, top_k, routing)
    aux = n_experts * (probs.mean(0) * _expert_share(idx, n_experts)).sum()
    return gates.to(x2.dtype), idx, aux


def _capacity(top_k: int, tokens: int, n_experts: int,
              capacity_factor: float) -> int:
    """Slots an expert has for a routing group of ``tokens`` tokens."""
    return max(int(math.ceil(top_k * tokens / n_experts * capacity_factor)),
               1)


def _positions_in_expert(flat_idx, n_experts: int):
    """Rank of each assignment within its expert (in assignment order),
    without a ``[T*k, E]`` one-hot."""
    tk = flat_idx.shape[0]
    order = torch.argsort(flat_idx, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(tk, device=flat_idx.device))
    sorted_flat = flat_idx[order].contiguous()
    first = torch.searchsorted(
        sorted_flat, torch.arange(n_experts, dtype=sorted_flat.dtype,
                                  device=flat_idx.device))
    return ranks - first[flat_idx]


class _Dispatch(torch.autograd.Function):
    """``buf = [x2; 0][slot_tok]``: the expert buffer ``[E, C, d]`` read
    from the tokens and the zero pad row.  Backward: token t's gradient is
    the sum, in k order, of the buffer gradient at its kept assignments'
    slots ``(e_ix, p_ix)`` (the pad row's is discarded)."""

    @staticmethod
    def forward(ctx, x2, slot_tok, e_ix, p_ix, keep, top_k: int):
        ctx.save_for_backward(e_ix, p_ix, keep)
        ctx.top_k = top_k
        x2p = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))])
        return x2p[slot_tok]

    @staticmethod
    def backward(ctx, dbuf):
        e_ix, p_ix, keep = ctx.saved_tensors
        rows = torch.where(keep[:, None], dbuf[e_ix, p_ix],
                           torch.zeros((), dtype=dbuf.dtype,
                                       device=dbuf.device))
        dx = rows.view(-1, ctx.top_k, rows.shape[-1]).sum(dim=1)
        return dx, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """``rows[j] = out_buf[e_ix[j], p_ix[j]]`` for a kept assignment j, 0
    for a dropped one.  Backward: slot (e, c)'s gradient is that of the
    assignment ``slot_asg[e, c]`` holding it, 0 for an empty slot."""

    @staticmethod
    def forward(ctx, out_buf, e_ix, p_ix, keep, slot_asg):
        ctx.save_for_backward(slot_asg)
        return torch.where(keep[:, None], out_buf[e_ix, p_ix],
                           torch.zeros((), dtype=out_buf.dtype,
                                       device=out_buf.device))

    @staticmethod
    def backward(ctx, drows):
        (slot_asg,) = ctx.saved_tensors
        drp = torch.cat([drows, drows.new_zeros((1, drows.shape[1]))])
        return drp[slot_asg], None, None, None, None


def _expert_ffn(p: MoEParams, e: int, xb, act: str):
    """Expert ``e`` on its ``[C, d]`` buffer (on a shard that splits the
    experts, the lists are keyed by global index; where they are
    tensor-parallel inside each expert, as the dense MLP)."""
    ep = getattr(p, "ep", None)
    gate, up, down = (getattr(p, k)[str(e) if ep and ep.axes else e]
                      for k in ("gate", "up", "down"))
    if ep and not ep.axes and tp_of(up) is not None:
        return tp.mlp_apply({"gate": gate, "up": up, "down": down}, xb,
                            act_fn(act), ep.mesh)
    h = act_fn(act)(linear_apply(gate, xb)) * linear_apply(up, xb)
    return linear_apply(down, h)


def _moe_tokens(p: MoEParams, x, n_experts, top_k, capacity_factor,
                routing, act):
    """One routing group: x [B, S, d] -> (y, aux, (idx, keep))."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    gates, idx, aux = _route(p, x2, n_experts, top_k, routing)

    cap = _capacity(top_k, t, n_experts, capacity_factor)
    flat = idx.reshape(-1)  # [T*k]
    pos = _positions_in_expert(flat, n_experts)
    keep = pos < cap
    # an overflowing assignment goes to the extra row E, column cap
    e_ix = torch.where(keep, flat, n_experts)
    p_ix = torch.where(keep, pos, cap)
    # each slot's assignment j (token j // k); T*k: no assignment
    slot_asg = torch.full(((n_experts + 1) * (cap + 1),), t * top_k,
                          dtype=torch.int64, device=x.device)
    slot_asg.index_put_((e_ix * (cap + 1) + p_ix,),
                        torch.arange(t * top_k, device=x.device))
    slot_asg = slot_asg.view(n_experts + 1, cap + 1)[:n_experts, :cap]
    # a kept assignment's slot; a dropped one reads a slot and is zeroed
    e_cl, p_cl = e_ix.clamp(max=n_experts - 1), p_ix.clamp(max=cap - 1)
    # [E, C, d], the pad row (token t) where a slot holds no token
    buf = _Dispatch.apply(x2, slot_asg // top_k, e_cl, p_cl, keep, top_k)
    out_buf = torch.stack([_expert_ffn(p, e, buf[e], act)
                           for e in range(n_experts)]).to(x.dtype)

    # combine: each assignment's row, weighted by its gate, summed over k
    rows = _Combine.apply(out_buf, e_cl, p_cl, keep, slot_asg)
    y = (rows.reshape(t, top_k, d) * gates[..., None].to(x.dtype)).sum(dim=1)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x2, act)
    return (y.reshape(b, s, d).to(x.dtype), aux,
            (idx.reshape(b, s, top_k), keep.reshape(b, s, top_k)))


def _router_logits(p: MoEParams, x2):
    """Router logits f32 ``[T, E]`` of a shard: a ``col`` router's
    columns gathered over "model"."""
    x = x2.to(torch.float32)
    shard = tp_of(p.router)
    if shard is None:
        return linear_apply(p.router, x)
    if shard.mode is Mode.COL:
        return tp.gather_from(linear_apply(p.router, tp.copy_to(
            x, shard.mesh)), shard.mesh)
    return tp.apply_linear(p.router, x)


def _route_mesh(p: MoEParams, x2, n_experts, top_k, routing, rows):
    """:func:`_route` of this rank's tokens within the global batch over
    ``rows``: (gates, local ids ``[t, k]``, global ids ``[T, k]``, this
    rank's share of the global aux)."""
    mesh = p.ep.mesh
    probs, idx, gates = _select(p, _router_logits(p, x2), top_k, routing)
    idx_all = mesh.all_gather(idx, rows, 0)
    me = tp.all_sum(probs.sum(0), mesh, rows) / idx_all.shape[0]
    aux = n_experts * (me * _expert_share(idx_all, n_experts)).sum() \
        / mesh.size(rows)
    return gates.to(x2.dtype), idx, idx_all, aux


def _exchange(p: MoEParams, idx_all, cap: int, rows, t: int, top_k: int):
    """The global slot table of one routing group and each rank's slots:
    its experts' (``p.ep.experts``) at its block of the capacity over the
    row axes its experts are not split over, padded to a multiple of that
    block.  Returns (the :class:`~repro_torch.models.tp.Exchange`, the
    global kept mask ``[T * k]``)."""
    ep, mesh = p.ep, p.ep.mesh
    n_experts = ep.n
    n, me = mesh.size(rows), mesh.index(rows)
    tk, big_t = t * top_k, idx_all.shape[0]
    none = big_t * top_k
    cb_axes = tuple(a for a in rows if a not in ep.axes)
    cb = -(-cap // mesh.size(cb_axes))
    cp = cb * mesh.size(cb_axes)
    flat = idx_all.reshape(-1)
    pos = _positions_in_expert(flat, n_experts)
    keep = pos < cap
    e_ix = torch.where(keep, flat, n_experts)
    p_ix = torch.where(keep, pos, cp)
    table = torch.full(((n_experts + 1) * (cp + 1),), none,
                       dtype=torch.int64, device=flat.device)
    table.index_put_((e_ix * (cp + 1) + p_ix,),
                     torch.arange(none, device=flat.device))
    table = table.view(n_experts + 1, cp + 1)[:n_experts, :cp]
    n_loc = len(ep.experts)
    blocks = []
    for q in range(n):
        c = mesh.coords_at(rows, q)
        e0 = mesh.index(ep.axes, c) * n_loc
        c0 = mesh.index(cb_axes, c) * cb
        blocks.append(table[e0:e0 + n_loc, c0:c0 + cb].reshape(-1))
    slots = torch.stack(blocks)                      # [n, rows] ids
    owner = slots // top_k // t                      # n: no token
    mine = owner == me
    send_tok = torch.where(mine, slots // top_k - me * t, t)
    send_asg = torch.where(mine, slots - me * tk, tk)
    inv = torch.full((none + 1,), n * slots.shape[1], dtype=torch.int64,
                     device=flat.device)
    inv[slots.reshape(-1)] = torch.arange(slots.numel(), device=flat.device)
    return tp.Exchange(mesh, rows, n, slots.shape[1], top_k,
                       send_tok.reshape(-1), send_asg.reshape(-1),
                       owner[me].clamp(max=n - 1),
                       inv[me * tk:(me + 1) * tk]), keep


def _moe_tokens_mesh(p: MoEParams, x, n_experts, top_k, capacity_factor,
                     routing, act):
    """:func:`_moe_tokens` on a shard (the module docstring)."""
    ep = p.ep
    mesh = ep.mesh
    rows = _ROWS[-1] if _ROWS else mesh.dp_axes
    rows = tuple(a for a in mesh.axis_names if a in rows)
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    gates, idx, idx_all, aux = _route_mesh(p, x2, n_experts, top_k,
                                           routing, rows)
    cap = _capacity(top_k, idx_all.shape[0], n_experts, capacity_factor)
    ex, keep = _exchange(p, idx_all, cap, rows, t, top_k)
    # the rows of experts held at other coordinates of these axes arrive
    # as partial sums: every token's input and gates feed them
    red = tuple(a for a in ep.axes if a not in rows)
    buf = tp.dispatch(tp.copy_to(x2, mesh, red) if red else x2, ex)
    buf = buf.view(len(ep.experts), -1, d)
    out = torch.stack([_expert_ffn(p, e, buf[i], act) for i, e in
                       enumerate(ep.experts)]).to(x.dtype).reshape(-1, d)
    picked = tp.combine(out, ex)
    g = tp.copy_to(gates, mesh, red) if red else gates
    y = (picked.reshape(t, top_k, d) * g[..., None].to(x.dtype)).sum(dim=1)
    if red:
        y = tp.reduce_from(y, mesh, red)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x2, act)
    me = mesh.index(rows)
    keep = keep.view(-1, t * top_k)[me]
    return (y.reshape(b, s, d).to(x.dtype), aux,
            (idx.reshape(b, s, top_k), keep.reshape(b, s, top_k)))


def moe_apply(p: MoEParams, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, routing: str = "softmax",
              act: str = "silu", moe_chunk: int = 0):
    """x: [B, S, d] -> (y, aux loss).  With ``0 < moe_chunk < S`` the
    positions are routed ``moe_chunk`` at a time (S must be a multiple),
    each chunk with its own capacity, and aux is the chunks' mean."""
    b, s, d = x.shape
    args = (n_experts, top_k, capacity_factor, routing, act)
    tokens = _moe_tokens_mesh if hasattr(p, "ep") else _moe_tokens
    if moe_chunk and s > moe_chunk:
        if s % moe_chunk:
            raise ValueError(f"sequence {s} is not a multiple of moe_chunk "
                             f"{moe_chunk}")
        ys, routes = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, moe_chunk):
            yc, a, r = tokens(p, x[:, i:i + moe_chunk], *args)
            ys.append(yc)
            routes.append(r)
            aux = aux + a
        y, aux = torch.cat(ys, dim=1), aux / (s // moe_chunk)
        route = tuple(torch.cat(z, dim=1) for z in zip(*routes))
    else:
        y, aux, route = tokens(p, x, *args)
    if not getattr(_SUSPENDED, "depth", 0):
        for rec in _RECORDERS:
            rec.append({"idx": route[0], "keep": route[1]})
    return y, aux
