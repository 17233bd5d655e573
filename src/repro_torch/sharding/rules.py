"""Partition specs for params, batches and caches (counterpart of
``repro.sharding.rules``, rule for rule).

Megatron-style pairing on the "model" axis: QKV/up/gate shard their
*output* dim (column-parallel), O/down shard their *input* dim
(row-parallel), one reduce per block.  Quantization scales/zeros and the
QA-LoRA adapters shard *with* their base matrix (a [L=K/g, r] follows K;
b [r, N] follows N).  MoE experts shard their expert dim over
("data", "model") when divisible, else fall back to TP inside the expert.

Every rule is an ordered candidate list filtered by divisibility against
the mesh, so any (arch x mesh) combination has a layout: a dim that fits
no axis is replicated, never an error.

A spec is a tuple with one entry per dim: an axis name, a tuple of names,
or None (replicated on that dim); ``()`` replicates the whole leaf, as
the reference's ``P()``.  A mesh is anything with a ``shape`` mapping of
axis name to size (:class:`repro_torch.launch.mesh.Mesh`), or that
mapping itself.

The reference stacks layers (and experts) on leading axes; the port holds
one module per layer (and expert).  :func:`param_specs` names each of the
port's leaves by the reference's tree names (``blocks.3.attn.wq.q.qweight``
-> ``blocks/attn/wq/q/qweight``, the layer index dropped), applies the rule
to the stacked shape, and drops the stack's leading entries.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

TP_AXIS = "model"
DP_AXES = ("pod", "data")  # present subset is used

# linear-role tables (names of the modules that *hold* a linear's params)
COL = {"wq", "wk", "wv", "wg", "wr", "gate", "up", "in_proj", "q_down",
       "q_up", "kv_down", "kv_up", "ck", "cr", "router", "mtp_proj"}
ROW = {"wo", "down", "out_proj", "cv"}

Spec = Tuple


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (or of that mapping itself)."""
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _axes_size(mesh_shape: dict, axes) -> int:
    if axes is None:
        return 1
    group = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in group:
        if a not in mesh_shape:
            return 0  # axis not on this mesh -> candidate invalid
    for a in group:
        n *= mesh_shape[a]
    return n


def _pick(candidates: Sequence[Tuple], shape, mesh_shape: dict) -> Spec:
    """First candidate spec (right-aligned) whose sharded dims divide."""
    nd = len(shape)
    for cand in candidates:
        spec = (None,) * (nd - len(cand)) + tuple(cand)
        ok = True
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            n = _axes_size(mesh_shape, axes)
            if n == 0 or shape[dim] % n != 0:
                ok = False
                break
        if ok:
            # a one-axis tuple is that axis, as PartitionSpec normalises it
            return tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                         else a for a in spec)
    return ()


def _dp(mesh_shape) -> Tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh_shape)


def padded(spec: Spec, ndim: int) -> Spec:
    """``spec`` with one entry per dim (``()`` becomes all None)."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in order."""
    out = []
    for axes in spec:
        if axes is not None:
            out += list(axes if isinstance(axes, tuple) else (axes,))
    return tuple(out)


def spec_for_param(names: Sequence[str], shape, mesh_shape: dict) -> Spec:
    """The spec of one leaf, from its tree names (``("blocks", "attn",
    "wq", "q", "qweight")``) and its (stacked) shape."""
    names = tuple(names)
    shape = tuple(shape)
    nd = len(shape)
    if nd == 0:
        return ()
    last = names[-1] if names else ""
    role = ("col" if any(n in COL for n in names)
            else "row" if any(n in ROW for n in names) else None)
    is_expert = ("moe" in names and "shared" not in names
                 and "router" not in names
                 and any(n in ("gate", "up", "down") for n in names))
    dp = _dp(mesh_shape)
    ep = (dp + (TP_AXIS,)) if dp else (TP_AXIS,)

    # embeddings / head
    if "embed" in names:
        return _pick([(TP_AXIS, None), (None, TP_AXIS)], shape, mesh_shape)
    if "head" in names:
        return _pick([(None, TP_AXIS)], shape, mesh_shape)

    # matrix-dim candidates by leaf kind and role
    if last in ("qweight", "w"):
        mat = [(None, TP_AXIS)] if role == "col" else \
              [(TP_AXIS, None)] if role == "row" else \
              [(None, TP_AXIS), (TP_AXIS, None)]
    elif last in ("scale", "zero"):
        mat = [(None, TP_AXIS)] if role == "col" else \
              [(TP_AXIS, None)] if role == "row" else [(None, TP_AXIS)]
    elif last == "a":     # adapter A [L(=K/g) or K, r]
        mat = [(TP_AXIS, None)] if role == "row" else [(None, None)]
    elif last == "b":     # adapter B [r, N]
        mat = [(None, TP_AXIS)] if role == "col" else [(None, None)]
    elif last in ("codes", "absmax"):  # NF4 baseline: replicate
        return ()
    elif last in ("conv_w", "conv_b"):
        mat = [(None,)]
    else:
        # norms / biases / small vectors: replicate
        return ()

    if is_expert and nd >= 3:
        # try expert-dim sharding first (full-mesh EP), else TP inside expert
        cands = [(ep,) + (None,) * len(mat[0]),
                 ((TP_AXIS,) + (None,) * len(mat[0]))] + \
                [(None,) + tuple(m) for m in mat]
        return _pick(cands, shape, mesh_shape)
    return _pick(mat, shape, mesh_shape)


def leaf_names(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A port leaf's tree names and stack index: ``blocks.3.moe.up.5.ad.b``
    -> (("blocks", "moe", "up", "ad", "b"), (3, 5))."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _named_leaves(params) -> Dict[str, Tuple[int, ...]]:
    """``{name: shape}`` of every buffer and parameter of a module, or of
    a ``{name: tensor or shape}`` dict."""
    if isinstance(params, dict):
        return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}
    out = {k: tuple(t.shape) for k, t in params.named_buffers()}
    out.update({k: tuple(t.shape) for k, t in params.named_parameters()})
    return out


def _stacked_specs(params, ms: dict) -> Dict[str, Tuple[Tuple[int, ...],
                                                         Spec]]:
    """``{leaf name: (stack, spec)}``: the reference's stacked leaf's
    sizes of the stack axes (layers, and experts, sized from the names
    present) and its spec padded to the stacked dims."""
    leaves = _named_leaves(params)
    stacks: Dict[Tuple[str, ...], list] = {}
    for name in leaves:
        names, index = leaf_names(name)
        top = stacks.setdefault(names, [0] * len(index))
        for i, ix in enumerate(index):
            top[i] = max(top[i], ix + 1)
    out = {}
    for name, shape in leaves.items():
        names, _ = leaf_names(name)
        stack = tuple(stacks[names])
        spec = spec_for_param(names, stack + shape, ms)
        out[name] = (stack, padded(spec, len(stack) + len(shape)))
    return out


def param_specs(params, mesh) -> Dict[str, Spec]:
    """``{leaf name: spec}`` of a params module (or a ``{name: tensor}``
    dict keyed like its leaves), each spec padded to the leaf's own dims:
    the rule applied to the reference's stacked leaf (layers, and experts,
    on leading axes, sized from the names present), the stack's entries
    dropped."""
    return {name: spec[len(stack):] for name, (stack, spec)
            in _stacked_specs(params, mesh_shape(mesh)).items()}


def _axes_tuple(axes) -> Tuple[str, ...]:
    return axes if isinstance(axes, tuple) else (axes,)


def expert_split(params, mesh) -> Dict[str, Tuple[Tuple[str, ...], int,
                                                  int]]:
    """``{leaf name: (axes, index, n)}`` of the leaves whose stack axis of
    ``n`` experts is split over ``axes`` (expert parallelism: full-mesh
    over the data-parallel axes and "model", or over "model" alone),
    ``index`` the leaf's expert.  A rank holds such a leaf only where its
    block of ``axes`` holds ``index`` (:func:`holds_expert`)."""
    out = {}
    for name, (stack, spec) in _stacked_specs(params,
                                              mesh_shape(mesh)).items():
        _, index = leaf_names(name)
        split = [d for d in range(len(stack)) if spec[d] is not None]
        if split:
            d = split[-1]
            out[name] = (_axes_tuple(spec[d]), index[d], stack[d])
    return out


def holds_expert(mesh, axes, index: int, n: int) -> bool:
    """Whether ``mesh``'s rank holds expert ``index`` of ``n`` split over
    ``axes`` (contiguous blocks in the axes' row-major order)."""
    return index // (n // mesh.size(axes)) == mesh.index(axes)


def rank_param_bytes(params, mesh) -> int:
    """The bytes of ``params`` that ``mesh``'s rank holds under the
    reference's layout: each leaf's own dims split as its spec says, and
    a leaf whose stack axis is sharded (experts over ("data", "model"))
    held only by the ranks whose block of that axis holds its index.
    (:func:`param_specs` drops the stack entries; this counts them.)"""
    ms = mesh_shape(mesh)
    experts = expert_split(params, ms)
    tensors = dict(params.named_buffers())
    tensors.update(params.named_parameters())
    total = 0
    for name, spec in param_specs(params, ms).items():
        if name in experts and not holds_expert(mesh, *experts[name]):
            continue
        t = tensors[name]
        split = math.prod(_axes_size(ms, a) for a in spec if a is not None)
        total += t.numel() // split * t.element_size()
    return total


def batch_spec_tree(batch, mesh):
    """Shard the batch dim over all DP axes (fallback: replicate); ``batch``
    a dict of tensors (or shapes)."""
    ms = mesh_shape(mesh)
    dp = _dp(ms)

    def one(x):
        shape = tuple(getattr(x, "shape", x))
        return _pick([(dp,) + (None,) * (len(shape) - 1)], shape, ms)

    return {k: one(v) for k, v in batch.items()}


def cache_spec_tree(cache, mesh):
    """Decode caches: batch over DP if divisible, else sequence over DP
    (long-context SP); heads/feature dims over "model".  ``cache`` a
    nested dict of tensors (or shapes); returns the same nesting."""
    ms = mesh_shape(mesh)
    dp = _dp(ms)

    def one(names, x):
        shape = tuple(getattr(x, "shape", x))
        nd = len(shape)
        if names and names[-1] == "len":
            return ()
        if names and names[-1] in ("k", "v"):      # [..., B, S, KvH, hd]
            cands = [(dp, None, TP_AXIS, None), (dp, None, None, TP_AXIS),
                     (None, dp, TP_AXIS, None), (None, dp, None, TP_AXIS),
                     (dp, None, None, None), (None, dp, None, None)]
            return _pick(cands, shape, ms)
        if names and names[-1] in ("c", "kr"):     # MLA [..., B, S, R]
            cands = [(dp, None, TP_AXIS), (None, dp, TP_AXIS),
                     (dp, None, None), (None, dp, None)]
            return _pick(cands, shape, ms)
        if names and names[-1] == "wkv":           # [..., B, H, K, V]
            return _pick([(dp, TP_AXIS, None, None), (dp, None, None, None),
                          (None, TP_AXIS, None, None)], shape, ms)
        if names and names[-1] == "ssm":           # [..., B, H, P, N]
            return _pick([(dp, TP_AXIS, None, None), (dp, None, None, None),
                          (None, TP_AXIS, None, None)], shape, ms)
        if names and names[-1] == "conv":          # [..., B, W, C]
            return _pick([(dp, None, TP_AXIS), (dp, None, None),
                          (None, None, TP_AXIS)], shape, ms)
        if nd >= 2:  # prev-token states etc. [..., B, 1, d]
            return _pick([(dp, None, TP_AXIS), (dp, None, None)], shape, ms)
        return ()

    def walk(names, node):
        if isinstance(node, dict):
            return {k: walk(names + (k,), v) for k, v in node.items()}
        return one(names, node)

    return walk((), cache)


__all__ = ["TP_AXIS", "DP_AXES", "COL", "ROW", "Spec", "mesh_shape",
           "padded", "spec_axes", "spec_for_param", "leaf_names",
           "param_specs", "expert_split", "holds_expert", "rank_param_bytes", "batch_spec_tree",
           "cache_spec_tree"]
