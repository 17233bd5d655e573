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

Each expert's gate, up and down are linears of the policy (paths
``moe/gate``, ``moe/up``, ``moe/down``) applied to that expert's
``[C, d]`` slice: the reference vmaps ``linear_apply`` over the experts,
here a loop calls it, so on the card every quantized expert linear is one
launch of the port's kernels at M = C.  The router is an fp linear tagged
exempt (conversion never quantizes it), computed in f32 outside any
kernel, as in the reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.schemes import linear_apply, linear_init
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


@contextlib.contextmanager
def record_routing():
    """Collect the routing of every :func:`moe_apply` call made in the
    context, in any thread of the process: yields a list that gains, per
    call in call order (so per layer within a forward), ``{"idx": [B, S,
    k] int64, "keep": [B, S, k] bool}`` on the call's device (``keep``
    False where capacity dropped the assignment).  For eager runs: a
    replayed CUDA graph records nothing."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _route(p: MoEParams, x2, n_experts: int, top_k: int, routing: str):
    """Router logits in f32 -> (gates [T, k] in x's dtype, expert ids
    [T, k], the Switch load-balance aux loss)."""
    logits = linear_apply(p.router, x2.to(torch.float32))  # [T, E]
    if routing == "softmax":
        gates, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    else:
        scores = torch.sigmoid(logits)
        _, idx = torch.topk(scores + p.bias[None, :], top_k, dim=-1)
        gates = torch.gather(scores, -1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = torch.zeros((n_experts,), dtype=torch.float32, device=x2.device)
    ce = ce.index_add(0, idx.reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.float32,
                                 device=x2.device))
    ce = ce / ce.sum().clamp_min(1.0)
    aux = n_experts * (me * ce).sum()
    return gates.to(x2.dtype), idx, aux


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


def _expert_ffn(p: MoEParams, e: int, xb, act: str):
    """Expert ``e`` on its ``[C, d]`` buffer."""
    h = act_fn(act)(linear_apply(p.gate[e], xb)) * linear_apply(p.up[e], xb)
    return linear_apply(p.down[e], h)


def _moe_tokens(p: MoEParams, x, n_experts, top_k, capacity_factor,
                routing, act):
    """One routing group: x [B, S, d] -> (y, aux, (idx, keep))."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    gates, idx, aux = _route(p, x2, n_experts, top_k, routing)

    cap = max(int(math.ceil(top_k * t / n_experts * capacity_factor)), 1)
    flat = idx.reshape(-1)  # [T*k]
    pos = _positions_in_expert(flat, n_experts)
    tok = torch.arange(t * top_k, device=x.device) // top_k
    keep = pos < cap
    # an overflowing assignment goes to the extra row E, column cap
    e_ix = torch.where(keep, flat, n_experts)
    p_ix = torch.where(keep, pos, cap)
    slot_tok = torch.full(((n_experts + 1) * (cap + 1),), t,
                          dtype=torch.int64, device=x.device)  # t: no token
    slot_tok.index_put_((e_ix * (cap + 1) + p_ix,), tok)
    slot_tok = slot_tok.view(n_experts + 1, cap + 1)[:n_experts, :cap]
    x2p = torch.cat([x2, x2.new_zeros((1, d))])  # the pad row
    buf = x2p[slot_tok]  # [E, C, d]
    out_buf = torch.stack([_expert_ffn(p, e, buf[e], act)
                           for e in range(n_experts)]).to(x.dtype)

    # combine: each assignment's row, weighted by its gate, summed over k
    rows = out_buf[e_ix.clamp(max=n_experts - 1), p_ix.clamp(max=cap - 1)]
    rows = torch.where(keep[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    y = (rows.reshape(t, top_k, d) * gates[..., None].to(x.dtype)).sum(dim=1)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x2, act)
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
    if moe_chunk and s > moe_chunk:
        if s % moe_chunk:
            raise ValueError(f"sequence {s} is not a multiple of moe_chunk "
                             f"{moe_chunk}")
        ys, routes = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, moe_chunk):
            yc, a, r = _moe_tokens(p, x[:, i:i + moe_chunk], *args)
            ys.append(yc)
            routes.append(r)
            aux = aux + a
        y, aux = torch.cat(ys, dim=1), aux / (s // moe_chunk)
        route = tuple(torch.cat(z, dim=1) for z in zip(*routes))
    else:
        y, aux, route = _moe_tokens(p, x, *args)
    for rec in _RECORDERS:
        rec.append({"idx": route[0], "keep": route[1]})
    return y, aux
