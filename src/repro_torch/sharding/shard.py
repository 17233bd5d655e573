"""This rank's shard of a params tree, and the gather that inverts it
(port-only: the reference places arrays with ``jax.device_put`` under
``NamedSharding``s and GSPMD slices them; here every rank holds its own
slices as ordinary tensors).

:func:`shard_params` slices each leaf of the full model by its spec
(:func:`repro_torch.sharding.rules.param_specs`): a dim sharded over
axes of n processes keeps this rank's ``1/n`` contiguous block, at its
row-major index over those axes.  The shard remembers the mesh and the
full tree's specs (``shard.mesh``, ``shard.specs``), and each linear a
:class:`LinearTP` that says how its forward runs on the "model" axis:

* ``col``: its output dim is sharded (codes, scales, zeros and B), A is
  replicated: it computes this rank's columns of the output;
* ``row``: its input dim is sharded (codes, scales, zeros and A), B is
  replicated: it computes a partial sum of the output;
* ``whole``: its shards do not hold whole quantization groups or columns
  (e.g. a row linear whose K / model splits a group: its scales and A
  are then replicated while its codes are sharded).  It runs whole on
  every rank, on its sharded frozen leaves gathered at each forward.

:func:`gather_params` all-gathers every sharded leaf back to the full
tree (on every rank).  Checkpoints, the merge and the tests use the pair
on ``name -> tensor`` dicts too (:func:`shard_tensors`,
:func:`gather_tensors`).

Decode caches: :func:`cache_part` slices a full decode cache into this
rank's part under :func:`~repro_torch.sharding.rules.cache_spec_tree`
(its lengths to its rows), :func:`gather_cache` inverts it, and
:func:`check_cache_part` holds a part's every leaf to its spec's shape.
:class:`DecodeLayout` names how the attention's leaves split (rows and
positions over the data-parallel axes, KV heads or the last dim over
"model"): the decode step reads it (:mod:`repro_torch.models.attention`).

Experts: where the rule splits an MoE layer's expert dim over mesh axes
(expert parallelism: over the data-parallel axes and "model", or over
"model" alone), a rank holds only its block of the experts, whole: the
layer's ``gate``, ``up`` and ``down`` become ``ModuleDict``s keyed by the
global expert index (so every leaf keeps its full tree's name,
``blocks.3.moe.up.5.ad.b``), and the layer carries an
:class:`ExpertShard` (``layer.ep``) naming the axes and the experts held.
Where the expert dim does not split, every rank holds every expert with
its linears ``col`` / ``row`` (tensor-parallel inside each expert), and
``layer.ep`` has no axes.  ``shard.specs`` is then a :class:`ShardSpecs`:
the specs of the full tree's leaves, and ``specs.experts`` the expert
leaves held only on their block (:func:`repro_torch.sharding.rules.expert_split`).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import itertools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import schemes
from repro_torch.core.quant import QuantizedLinear
from .rules import (TP_AXIS, Spec, cache_spec_tree, expert_split,
                    holds_expert, padded, param_specs)

_A, _B = "ad.a", "ad.b"


def shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a new contiguous tensor;
    ``t`` itself when nothing is sharded)."""
    out = t
    for dim, axes in enumerate(padded(spec, t.ndim)):
        if axes is None:
            continue
        n, i = mesh.size(axes), mesh.index(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n} processes)")
        size = t.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out if out is t else out.contiguous().clone()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's block under ``spec``
    (a collective: every rank of the axes calls it), detached."""
    t = t.detach()
    for dim, axes in enumerate(padded(spec, t.ndim)):
        if axes is not None:
            t = mesh.all_gather(t, axes, dim)
    return t


class ShardSpecs(dict):
    """``{leaf name: spec}`` of a shard's full tree
    (:func:`~repro_torch.sharding.rules.param_specs`), and ``experts``:
    ``{leaf name: (axes, index, n)}`` of the expert leaves a rank holds
    only where its block of ``axes`` holds expert ``index`` of ``n``."""

    def __init__(self, specs, experts=None):
        super().__init__(specs)
        self.experts = dict(experts or {})


def _expert_parts(name: str) -> Tuple[str, int, str]:
    """An expert leaf's (list, expert index, leaf in the expert):
    ``blocks.3.moe.up.5.ad.b`` -> ("blocks.3.moe.up", 5, "ad.b")."""
    parts = name.split(".")
    i = max(j for j, p in enumerate(parts) if p.isdigit())
    return ".".join(parts[:i]), int(parts[i]), ".".join(parts[i + 1:])


def shard_tensors(tensors: Dict, specs: Dict[str, Spec], mesh) -> Dict:
    """``{name: block}`` of ``{name: tensor}`` under ``specs`` (a name
    missing from ``specs`` is replicated; an expert leaf of
    ``specs.experts`` that this rank does not hold is left out)."""
    experts = getattr(specs, "experts", {})
    return {k: shard_tensor(t, specs.get(k, ()), mesh)
            for k, t in tensors.items()
            if k not in experts or holds_expert(mesh, *experts[k])}


def gather_tensors(tensors: Dict, specs: Dict[str, Spec], mesh) -> Dict:
    """The inverse of :func:`shard_tensors` (collective: every rank
    passes the same names in the same order, its own experts' in place
    of another's).  Each expert leaf comes back for every expert, in the
    full tree's order: the held experts of a list are stacked and
    gathered over their axes."""
    experts = getattr(specs, "experts", {})
    groups: Dict[Tuple[str, str], list] = {}
    for k in tensors:
        if k in experts:
            pre, _, leaf = _expert_parts(k)
            groups.setdefault((pre, leaf), []).append(k)
    full = {}
    for (pre, leaf), names in groups.items():
        axes, _, n = experts[names[0]]
        stacked = torch.stack([tensors[k].detach() for k in names])
        spec = (axes,) + padded(specs.get(names[0], ()), stacked.ndim - 1)
        for e, t in enumerate(gather_tensor(stacked, spec, mesh)):
            full[f"{pre}.{e}.{leaf}"] = t
    out, done = {}, set()
    for k, t in tensors.items():
        if k not in experts:
            out[k] = gather_tensor(t, specs.get(k, ()), mesh)
            continue
        pre, _, _ = _expert_parts(k)
        if pre not in done:
            done.add(pre)
            leaves = [leaf for p, leaf in groups if p == pre]
            for e in range(experts[k][2]):
                out.update((f"{pre}.{e}.{leaf}", full[f"{pre}.{e}.{leaf}"])
                           for leaf in leaves)
    return out


class Mode(enum.Enum):
    """A linear's tensor-parallel mode (the module docstring)."""

    COL = "col"
    ROW = "row"
    WHOLE = "whole"


@dataclasses.dataclass(frozen=True)
class LinearTP:
    """How a linear of a shard runs on the mesh's "model" axis: its
    :class:`Mode`, and (whole) the frozen payload leaves it gathers at
    each forward, with their specs."""

    mesh: object
    mode: Mode
    gathered: Tuple[Tuple[str, Spec], ...] = ()

    def whole(self, lp: schemes.LinearParams) -> schemes.LinearParams:
        """``lp`` with its sharded frozen leaves gathered (the adapters
        are the same tensors)."""
        if not self.gathered:
            return lp
        spec = dict(self.gathered)
        data = {}
        for key, v in lp.data.items():
            if isinstance(v, QuantizedLinear):
                bufs = {n: gather_tensor(t, spec[f"{key}.{n}"], self.mesh)
                        if f"{key}.{n}" in spec else t
                        for n, t in v.named_buffers(recurse=False)}
                v = QuantizedLinear(bufs["qweight"], bufs["scale"],
                                    bufs["zero"], v.bits, v.group_size)
            elif isinstance(v, torch.Tensor) and key in spec:
                v = gather_tensor(v, spec[key], self.mesh)
            data[key] = v
        return schemes.LinearParams(data, lp.scheme, lp.policy, lp.exempt)


def _linear_tp(lp: schemes.LinearParams, specs: Dict[str, Spec],
               mesh) -> LinearTP:
    """The mode of one linear from its leaves' specs (``specs`` keyed by
    the leaf's name inside the linear: ``q.qweight``, ``ad.a``, ``w``)."""
    def on(name, dim):
        s = specs[name]
        return len(s) > 0 and s[dim] == TP_AXIS

    sharded = [n for n, s in specs.items() if any(a is not None for a in s)]
    base = [n for n in specs if n not in (_A, _B)]
    if sharded and all(on(n, -1) for n in base) and (
            _B not in specs or on(_B, -1)) and _A not in sharded:
        return LinearTP(mesh, Mode.COL)
    if sharded and all(on(n, 0) for n in base) and (
            _A not in specs or on(_A, 0)) and _B not in sharded:
        return LinearTP(mesh, Mode.ROW)
    trainable = set(schemes.get_scheme(lp.scheme).trainable_paths(lp.data))
    bad = [n for n in sharded if n.split(".")[0] in trainable]
    if bad:
        raise NotImplementedError(
            f"a {lp.scheme} linear whose adapter leaves {bad} are sharded "
            f"but whose base does not follow them has no tensor-parallel "
            f"forward")
    return LinearTP(mesh, Mode.WHOLE, tuple((n, specs[n]) for n in sharded))


def _map_leaves(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A copy of ``module`` whose buffers and parameters are ``fn(name,
    tensor)`` (a parameter stays a trainable ``nn.Parameter``); the
    containers are copied shallowly, as ``schemes.map_linears`` does."""
    out = copy.copy(module)
    out._buffers = {k: (fn(prefix + k, t) if t is not None else None)
                    for k, t in module._buffers.items()}
    # a parameter gets storage of its own even where it is not sharded
    out._parameters = {k: (nn.Parameter(fn(prefix + k, t.detach()).clone(),
                                        requires_grad=t.requires_grad)
                           if t is not None else None)
                       for k, t in module._parameters.items()}
    out._modules = {k: (_map_leaves(m, fn, f"{prefix}{k}.")
                        if m is not None else None)
                    for k, m in module._modules.items()}
    return out


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """How a shard's MoE layer holds its ``n`` experts: ``axes`` the mesh
    axes its expert dim is split over (() where every rank holds every
    expert, tensor-parallel inside each), ``experts`` the global indices
    of the ones this rank holds, in order."""

    mesh: object
    axes: Tuple[str, ...]
    experts: Tuple[int, ...]
    n: int


_EXPERT_LISTS = ("gate", "up", "down")


def _is_moe(module: nn.Module) -> bool:
    return all(k in module._modules for k in ("router",) + _EXPERT_LISTS)


def _leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(itertools.chain(module.named_buffers(),
                                module.named_parameters()))


def _map_moe(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A shallow copy of ``module`` with each MoE layer ``fn(prefix,
    copy of the layer)`` (containers copied, leaves shared)."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    if _is_moe(module):
        return fn(prefix, out)
    out._modules = {k: (_map_moe(m, fn, f"{prefix}{k}.")
                        if m is not None else None)
                    for k, m in module._modules.items()}
    return out


def _hold_experts(params: nn.Module, specs: ShardSpecs, mesh) -> nn.Module:
    """``params`` with each MoE layer keeping the experts this rank holds
    (``ModuleDict``s keyed by global index) and its :class:`ExpertShard`."""
    def hold(prefix, moe):
        n = len(moe.gate)
        first = next(iter(_leaves(moe.gate[0])))
        axes = specs.experts.get(f"{prefix}gate.0.{first}", ((),))[0]
        if axes:
            per, i = n // mesh.size(axes), mesh.index(axes)
            held = tuple(range(i * per, (i + 1) * per))
            for kind in _EXPERT_LISTS:
                moe._modules[kind] = nn.ModuleDict(
                    {str(e): moe._modules[kind][e] for e in held})
        else:
            held = tuple(range(n))
        moe.ep = ExpertShard(mesh, axes, held, n)
        return moe
    return _map_moe(params, hold)


def _gather_experts(shard: nn.Module, specs: ShardSpecs, mesh) -> nn.Module:
    """The inverse of :func:`_hold_experts` (collective): each expert list
    whole again, every leaf stacked over the held experts and gathered
    over their axes."""
    def gather(prefix, moe):
        ep = moe.__dict__.pop("ep")
        if not ep.axes:
            return moe
        for kind in _EXPERT_LISTS:
            held = [moe._modules[kind][str(e)] for e in ep.experts]
            full = {}
            for name, t in _leaves(held[0]).items():
                stacked = torch.stack([_leaves(h)[name].detach()
                                       for h in held])
                spec = specs[f"{prefix}{kind}.{ep.experts[0]}.{name}"]
                full[name] = gather_tensor(
                    stacked, (ep.axes,) + padded(spec, t.ndim), mesh)
            moe._modules[kind] = nn.ModuleList(
                _map_leaves(held[0], lambda n, t, e=e: full[n][e].clone())
                for e in range(ep.n))
        return moe
    return _map_moe(shard, gather)


def shard_params(params: nn.Module, mesh) -> nn.Module:
    """This rank's shard of the full ``params`` (see the module
    docstring); ``params`` itself on a mesh of one process."""
    if mesh.single:
        return params
    specs = ShardSpecs(param_specs(params, mesh),
                       expert_split(params, mesh))
    shard = _map_leaves(_hold_experts(params, specs, mesh),
                        lambda n, t: shard_tensor(t, specs[n], mesh))
    for name, lp in shard.named_modules():
        if schemes.is_linear(lp):
            pre = f"{name}." if name else ""
            own = [n for n, _ in lp.named_buffers()] + \
                [n for n, _ in lp.named_parameters()]
            lp.tp = _linear_tp(lp, {n: specs[pre + n] for n in own}, mesh)
    shard.mesh, shard.specs = mesh, specs
    return shard


def gather_params(shard: nn.Module, mesh) -> nn.Module:
    """The full tree of which ``shard`` is this rank's part (collective;
    on every rank), with no mesh left on it.  A tree without
    ``shard.specs`` (one process) comes back as it is."""
    specs = getattr(shard, "specs", None)
    if specs is None or mesh.single:
        return shard
    experts = getattr(specs, "experts", {})
    full = _map_leaves(_gather_experts(shard, specs, mesh),
                       lambda n, t: t if n in experts
                       else gather_tensor(t, specs.get(n, ()), mesh))
    for m in full.modules():
        m.__dict__.pop("tp", None)
    full.__dict__.pop("mesh", None)
    full.__dict__.pop("specs", None)
    return full


def tp_of(module):
    """The :class:`LinearTP` of a linear of a shard whose "model" axis has
    more than one process, else None."""
    tp = getattr(module, "tp", None)
    return tp if tp is not None and tp.mesh.size(TP_AXIS) > 1 else None


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

# the attention leaves of a decode cache, by name: their dims after the
# layer axis (the reference's cache_spec_tree candidates are written on
# these)
_ATTN_DIMS = {"k": ("rows", "seq", "heads", "feature"),
              "v": ("rows", "seq", "heads", "feature"),
              "c": ("rows", "seq", "feature"),
              "kr": ("rows", "seq", "feature")}


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _walk(node, spec, fn, names=()):
    if isinstance(node, dict):
        return {k: _walk(v, spec[k], fn, names + (k,))
                for k, v in node.items()}
    return fn(names, node, spec)


def _shape(x) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", x))


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """How a rank's decode cache splits its attention leaves (``k`` / ``v``
    ``[L, B, S, KvH, hd]``, MLA's ``c`` / ``kr`` ``[L, B, S, R]``) under
    :func:`~repro_torch.sharding.rules.cache_spec_tree`, each entry as a
    spec's: the axes a dim splits over, None where it does not.  ``rows``
    the axes its batch rows split over (() where every rank holds every
    row), ``seq`` the axes its positions split over (a rank at index i
    over them holds positions ``[i * S / n, (i + 1) * S / n)``), ``heads``
    "model" where the KV heads split over it, ``feature`` "model" where
    the last dim (head_dim, MLA's latent and rope key) does."""

    mesh: object
    rows: Tuple[str, ...]
    seq: Optional[Tuple[str, ...]]
    heads: Optional[str]
    feature: Optional[str]

    def seq_start(self, s_local: int) -> int:
        """The first global position of a rank part's ``s_local``
        positions."""
        return 0 if self.seq is None else \
            self.mesh.index(self.seq) * s_local


def decode_layout(cache, mesh) -> DecodeLayout:
    """The :class:`DecodeLayout` of a full decode cache (tensors or
    shapes) on ``mesh``; raises NotImplementedError where its attention
    leaves do not split alike (no ported config's do not)."""
    specs = cache_spec_tree(cache, mesh)
    seen = set()

    def one(names, x, spec):
        dims = _ATTN_DIMS.get(names[-1]) if names else None
        if dims is None:
            return
        spec = padded(spec, len(_shape(x)))[1:]
        seen.add(tuple((d, _axes_of(a)) for d, a in zip(dims, spec)))
    _walk(cache, specs, one)
    if len(seen) != 1:
        raise NotImplementedError(
            f"the decode cache's attention leaves split differently "
            f"{sorted(seen)}: no decode step holds them")
    split = dict(next(iter(seen)))

    def over(axes):  # axes of one process split nothing
        return axes if mesh.size(axes) > 1 else None
    return DecodeLayout(mesh, over(split["rows"]) or (), over(split["seq"]),
                        TP_AXIS if over(split.get("heads", ())) else None,
                        TP_AXIS if over(split["feature"]) else None)


def _rows(cache, mesh) -> Tuple[str, ...]:
    return decode_layout(cache, mesh).rows


def cache_part(cache, mesh) -> Dict:
    """This rank's part of a full decode cache: each leaf sliced by
    :func:`~repro_torch.sharding.rules.cache_spec_tree` (new tensors), the
    lengths to the rank's rows (all of them where the rows do not
    split)."""
    specs = cache_spec_tree(cache, mesh)

    def part(t, spec):
        out = shard_tensor(t, spec, mesh)
        return out.clone() if out is t else out
    out = _walk(cache, specs, lambda names, t, spec: part(t, spec))
    out["len"] = part(cache["len"], (_rows(cache, mesh) or None,))
    return out


def gather_cache(part, cache, mesh) -> Dict:
    """The full decode cache of which ``part`` is this rank's
    (:func:`cache_part` of a cache shaped as ``cache``, tensors or shapes;
    collective: every rank calls it), detached."""
    specs = cache_spec_tree(cache, mesh)

    def whole_leaf(t, spec):
        out = gather_tensor(t, spec, mesh)
        return out.clone() if out.data_ptr() == t.data_ptr() else out
    out = _walk(part, specs, lambda names, t, spec: whole_leaf(t, spec))
    out["len"] = whole_leaf(part["len"], (_rows(cache, mesh) or None,))
    return out


def _leaf_shapes(tree, names=()) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """``{leaf path: shape}`` of a nested dict of tensors (or shapes)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, names + (k,)))
        return out
    return {names: _shape(tree)}


def check_cache_part(part, cache, mesh) -> None:
    """Raises ValueError unless every leaf of ``part`` has the shape of
    its spec's part of the full ``cache`` (tensors or shapes) on ``mesh``
    (:func:`cache_part`'s), lengths included: a layout that drifted from
    the rules is refused, not computed on."""
    want = {}

    def one(names, x, spec):
        full = _shape(x)
        want[names] = tuple(n // mesh.size(a) if a is not None else n
                            for n, a in zip(full, padded(spec, len(full))))
    _walk(cache, cache_spec_tree(cache, mesh), one)
    want[("len",)] = (_shape(cache["len"])[0]
                      // mesh.size(_rows(cache, mesh)),)
    got = _leaf_shapes(part)
    bad = [(".".join(k), got.get(k), v) for k, v in want.items()
           if got.get(k) != v]
    if bad:
        raise ValueError(f"a rank's decode cache is not its part under "
                         f"cache_spec_tree: (leaf, shape, part) {bad[:4]}")


__all__ = ["Mode", "LinearTP", "ExpertShard", "ShardSpecs", "shard_tensor",
           "gather_tensor", "shard_tensors", "gather_tensors",
           "shard_params", "gather_params", "tp_of", "DecodeLayout",
           "decode_layout", "cache_part", "gather_cache",
           "check_cache_part"]
