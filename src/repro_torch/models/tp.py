"""Tensor parallelism on a mesh's "model" axis for the dense gqa block,
the embedding and the loss (Megatron-LM's operators; the reference gets
the same math from GSPMD).

A shard's linears carry a :class:`~repro_torch.sharding.shard.LinearTP`
(``col``, ``row`` or ``whole``).  Between them an activation is either
*full* (the same on every rank) or *sharded* on its last dim.  A full
activation's gradient on a rank is its whole gradient, a sharded one's
this rank's block of it.  Four operators move between the two, each a
``torch.autograd.Function`` over the "model" group:

* :func:`copy_to` (identity; all-reduce in the backward) before a
  consumer that computes only this rank's part (a ``col`` linear, the
  attention over this rank's heads): each rank's gradient is then a
  partial sum;
* :func:`reduce_from` (all-reduce; identity in the backward) after a
  ``row`` linear, whose output is a partial sum;
* :func:`gather_from` (all-gather; this rank's slice in the backward)
  where a sharded activation feeds a consumer every rank computes whole;
* :func:`scatter_to` (this rank's slice; all-gather in the backward)
  where a full activation feeds a ``row`` linear.

:func:`copy_to` and :func:`reduce_from` take other axes too: the MoE's
combine sums the rows of experts held on other ranks over the axes its
expert dim is split over beyond the token owners' (:mod:`repro_torch.models.moe`).

Expert parallelism adds two operators over the ranks that split the
tokens (the data-parallel axes; :class:`Exchange` is their plan, from
the routing every rank knows whole):

* :func:`dispatch`: each rank's tokens to the ranks whose experts' slots
  hold them (an all-to-all of fixed blocks, one for each rank, its rows
  zero where it owns no slot's token); backward, the slots' gradients
  all-gathered and each token's summed over its assignments in k order,
  as the one-device dispatch's backward does;
* :func:`combine`: every rank's expert outputs all-gathered, each
  assignment's row read at its slot; backward, each slot's gradient
  sent back by the rank owning its token (an all-to-all).

Both move fixed shapes (no sizes exchanged): a step stays capturable and
the dry run traces it on ``meta``.

Floating collectives run in f32 and cast back (the exchanges move rows
as they are).  On a mesh whose "model" axis has one process none of the
Megatron operators runs: the model's functions take their one-device
path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.schemes import linear_apply
from repro_torch.sharding.rules import TP_AXIS
from repro_torch.sharding.shard import Mode, tp_of

__all__ = ["copy_to", "reduce_from", "gather_from", "scatter_to",
           "all_sum", "Exchange", "dispatch", "combine", "full_output",
           "rank_block", "apply_linear", "qkv", "attn_output",
           "mlp_apply", "model_mesh",
           "embed", "logits", "xent_sums", "greedy"]


def _sum(x: torch.Tensor, mesh, axes=TP_AXIS) -> torch.Tensor:
    if x.dtype.is_floating_point and x.dtype != torch.float32:
        return mesh.all_reduce(x.to(torch.float32), axes).to(x.dtype)
    return mesh.all_reduce(x, axes)


def _slice(x: torch.Tensor, mesh) -> torch.Tensor:
    n, i = mesh.size(TP_AXIS), mesh.index(TP_AXIS)
    size = x.shape[-1] // n
    return x.narrow(-1, i * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(x, TP_AXIS, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh), None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, TP_AXIS, g.dim() - 1), None


def copy_to(x, mesh, axes=TP_AXIS):
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes=TP_AXIS):
    return _ReduceFrom.apply(x, mesh, axes)


def all_sum(x, mesh, axes):
    """``x`` summed over ``axes``, its gradient summed likewise: a term
    every rank computes from the sum and adds to its own part of the
    loss (the MoE's aux over the global batch, each rank adding its
    share)."""
    return _AllSum.apply(x, mesh, axes)


def gather_from(x, mesh):
    return _GatherFrom.apply(x, mesh)


def scatter_to(x, mesh):
    return _ScatterTo.apply(x, mesh)


class Exchange(NamedTuple):
    """The plan of one routing group's :func:`dispatch` and
    :func:`combine` over ``axes`` (``n`` ranks, this one at ``me``), each
    rank computing ``rows`` expert slots: ``send_tok`` / ``send_asg``
    ``[n * rows]`` this rank's local token (assignment) in each slot of
    each rank, the pad row where it owns none; ``owner`` ``[rows]`` the
    rank owning each of this rank's slots; ``inv`` ``[t * k]`` each local
    assignment's slot in the gathered ``[n * rows]``, ``n * rows`` (the pad
    row) where it is dropped or held on a rank outside ``axes``."""

    mesh: object
    axes: tuple
    n: int
    rows: int
    top_k: int
    send_tok: torch.Tensor
    send_asg: torch.Tensor
    owner: torch.Tensor
    inv: torch.Tensor


def _padded(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[-1]))])


def _from_owners(sent, ex: Exchange):
    """Each of this rank's slots' row from the block its owner sent."""
    recv = ex.mesh.all_to_all(sent.contiguous(), ex.axes)
    recv = recv.view(ex.n, ex.rows, recv.shape[-1])
    return recv[ex.owner, torch.arange(ex.rows, device=recv.device)]


def _to_assignments(rows, ex: Exchange):
    """Every rank's slot rows gathered, each local assignment's read."""
    return _padded(ex.mesh.all_gather(rows.contiguous(), ex.axes, 0))[ex.inv]


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, ex):
        ctx.ex = ex
        return _from_owners(_padded(x2)[ex.send_tok], ex)

    @staticmethod
    def backward(ctx, dbuf):
        ex = ctx.ex
        rows = _to_assignments(dbuf, ex)
        return rows.view(-1, ex.top_k, rows.shape[-1]).sum(dim=1), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_rows, ex):
        ctx.ex = ex
        return _to_assignments(out_rows, ex)

    @staticmethod
    def backward(ctx, drows):
        return _from_owners(_padded(drows)[ctx.ex.send_asg], ctx.ex), None


def dispatch(x2, ex: Exchange):
    """This rank's expert slots ``[rows, d]`` filled from the local tokens
    ``x2 [t, d]`` of every rank of ``ex.axes`` (zero rows for empty
    slots)."""
    return _Dispatch.apply(x2, ex)


def combine(out_rows, ex: Exchange):
    """Each local assignment's output row ``[t * k, d]`` from the slot
    outputs ``out_rows [rows, d]`` of every rank of ``ex.axes`` (zero
    where it was dropped or its expert is held outside them)."""
    return _Combine.apply(out_rows, ex)


def full_output(lp, x, mesh):
    """A shard's linear on a full ``x``, its output full on every rank: a
    ``col`` linear's columns gathered, a ``row`` linear's partial sums
    reduced."""
    mode = _mode(lp)
    if mode is Mode.COL:
        return gather_from(apply_linear(lp, copy_to(x, mesh)), mesh)
    if mode is Mode.ROW:
        return reduce_from(apply_linear(lp, scatter_to(x, mesh)), mesh)
    return apply_linear(lp, x)


def rank_block(x, mesh):
    """This rank's block of ``x``'s last dim over "model" where it
    divides, else ``x`` (a cache leaf's ``(..., "model")`` spec)."""
    if x.shape[-1] % mesh.size(TP_AXIS):
        return x
    return _slice(x, mesh)


def apply_linear(lp, x):
    """A shard's linear on ``x``: its own leaves (``col``, ``row``: kernel
    3 at the shard's shape on the card), or whole with its sharded frozen
    leaves gathered."""
    return linear_apply(tp_of(lp).whole(lp), x)


def _mode(lp) -> Mode:
    return tp_of(lp).mode


# ---------------------------------------------------------------------------
# the attention and the MLP
# ---------------------------------------------------------------------------


def qkv(p, x, cfg, mesh):
    """q, k, v ``[B, S, heads, hd]`` of a shard's gqa attention, before
    the norms and rope, and whether they hold this rank's query heads
    (``n_heads % model == 0`` and ``wq`` a ``col`` linear) or all of
    them.  With this rank's query heads, k and v hold the KV heads those
    query heads read: this rank's own when ``wk``/``wv`` shard whole KV
    heads, else the full k and v (gathered over "model" where sharded)
    under :func:`copy_to`, indexed by query head."""
    t, r = mesh.size(TP_AXIS), mesh.index(TP_AXIS)
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    modes = {n: _mode(p[n]) for n in ("wq", "wk", "wv")}
    xs = copy_to(x, mesh) if Mode.COL in modes.values() else x
    out = {n: apply_linear(p[n], xs if modes[n] is Mode.COL else x)
           for n in modes}

    def full(n):
        return gather_from(out[n], mesh) if modes[n] is Mode.COL else out[n]

    if not (modes["wq"] is Mode.COL and h % t == 0):
        return (full("wq").reshape(b, s, h, hd),
                full("wk").reshape(b, s, kvh, hd),
                full("wv").reshape(b, s, kvh, hd), False)
    hq = h // t
    q = out["wq"].reshape(b, s, hq, hd)
    heads = _kv_heads(modes, h, kvh, t, r)
    if heads is None:
        return (q, out["wk"].reshape(b, s, kvh // t, hd),
                out["wv"].reshape(b, s, kvh // t, hd), True)
    k, v = (copy_to(full(n), mesh).reshape(b, s, kvh, hd)[:, :, heads]
            for n in ("wk", "wv"))
    return q, k, v, True


def _kv_heads(modes, h: int, kvh: int, t: int, r: int):
    """The KV heads rank ``r``'s query heads read, when it holds its query
    heads and ``wk``/``wv`` do not shard whole KV heads; None when they
    do (the rank's own block of them)."""
    if modes["wk"] is Mode.COL and modes["wv"] is Mode.COL and kvh % t == 0:
        return None
    hq = h // t
    idx = [(r * hq + j) // (h // kvh) for j in range(hq)]
    heads = sorted(set(idx))
    rep = hq // len(heads)
    if idx != [u for u in heads for _ in range(rep)]:
        heads = idx  # no even grouping: one KV head per query head
    return heads


def attn_output(p, o, heads: bool, mesh):
    """``wo`` on the attention's output ``o [B, S, heads * hd]`` (this
    rank's query heads when ``heads``, else all): full on every rank."""
    mode = _mode(p["wo"])
    if mode is Mode.ROW:
        return reduce_from(apply_linear(p["wo"], o if heads else
                                        scatter_to(o, mesh)), mesh)
    if mode is not Mode.WHOLE:
        raise NotImplementedError(f"wo as a {mode} linear")
    return apply_linear(p["wo"], gather_from(o, mesh) if heads else o)


def mlp_apply(p, x, act, mesh):
    """The gated (or plain) MLP of a shard: full on every rank."""
    mode = _mode(p["up"])
    if "gate" in p and _mode(p["gate"]) is not mode:
        raise NotImplementedError("gate and up split differently")
    sharded = mode is Mode.COL
    xs = copy_to(x, mesh) if sharded else x
    u = apply_linear(p["up"], xs)
    h = act(apply_linear(p["gate"], xs)) * u if "gate" in p else act(u)
    dmode = _mode(p["down"])
    if dmode is Mode.ROW:
        return reduce_from(apply_linear(p["down"], h if sharded else
                                        scatter_to(h, mesh)), mesh)
    if dmode is not Mode.WHOLE:
        raise NotImplementedError(f"down as a {dmode} linear")
    return apply_linear(p["down"], gather_from(h, mesh) if sharded else h)


# ---------------------------------------------------------------------------
# the embedding, the head and the loss
# ---------------------------------------------------------------------------


def model_mesh(params) -> Optional[object]:
    """The mesh of a shard whose "model" axis has more than one process,
    else None."""
    mesh = getattr(params, "mesh", None)
    return mesh if mesh is not None and mesh.size(TP_AXIS) > 1 else None


def embed(table, tokens, mesh):
    """Token embeddings [..., d] from this rank's block of the embedding
    ``table``, split over the vocabulary: a masked lookup, then a sum over
    "model".  The embedding is frozen: no gradient."""
    rows = table.shape[0]
    local = tokens.to(torch.int64) - mesh.index(TP_AXIS) * rows
    own = (local >= 0) & (local < rows)
    x = torch.where(own[..., None], table[local.clamp(0, rows - 1)], 0)
    return _sum(x, mesh)


def logits(head, h, mesh):
    """A shard's logits f32 over this rank's vocabulary columns (the head
    a ``col`` linear)."""
    return apply_linear(head, copy_to(h, mesh)).to(torch.float32)


def xent_sums(head, h, labels, mesh):
    """(sum of the masked cross-entropy, count of labels >= 0) of one
    chunk with the head's vocabulary split over "model": the log-sum-exp
    through an all-reduce of the max and then of the sum of exps, the
    label's logit from the rank that owns it."""
    z = logits(head, h, mesh)
    y = labels.to(torch.int64)
    mask = (y >= 0).to(torch.float32)
    cols = z.shape[-1]
    m = mesh.all_reduce(z.detach().amax(dim=-1), TP_AXIS, op="max")
    lse = m + torch.log(reduce_from(torch.exp(z - m[..., None]).sum(-1),
                                    mesh))
    local = y - mesh.index(TP_AXIS) * cols
    own = (local >= 0) & (local < cols)
    ll = torch.where(own, z.gather(-1, local.clamp(0, cols - 1)[..., None])
                     [..., 0], 0.0)
    ll = reduce_from(ll, mesh)
    return ((lse - ll) * mask).sum(), mask.sum()


def greedy(logits, mesh):
    """The argmax [B] int32 of logits split over "model" (this rank's
    vocabulary block ``[B, V / model]``): each rank's largest logit and
    its global column gathered, the first rank holding the largest wins
    (the whole row's argmax, its first maximum)."""
    cols = logits.shape[-1]
    val, idx = logits.max(dim=-1)
    idx = idx + mesh.index(TP_AXIS) * cols
    vals = mesh.all_gather(val[None].contiguous(), TP_AXIS, 0)
    idxs = mesh.all_gather(idx[None].contiguous(), TP_AXIS, 0)
    win = vals.argmax(dim=0)
    rows = torch.arange(win.shape[0], device=win.device)
    return idxs[win, rows].to(torch.int32)
