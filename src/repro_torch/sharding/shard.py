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
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.core import schemes
from repro_torch.core.quant import QuantizedLinear
from .rules import TP_AXIS, Spec, padded, param_specs

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


def shard_tensors(tensors: Dict, specs: Dict[str, Spec], mesh) -> Dict:
    """``{name: block}`` of ``{name: tensor}`` under ``specs`` (a name
    missing from ``specs`` is replicated)."""
    return {k: shard_tensor(t, specs.get(k, ()), mesh)
            for k, t in tensors.items()}


def gather_tensors(tensors: Dict, specs: Dict[str, Spec], mesh) -> Dict:
    """The inverse of :func:`shard_tensors` (collective: every rank
    passes the same names in the same order)."""
    return {k: gather_tensor(t, specs.get(k, ()), mesh)
            for k, t in tensors.items()}


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


def shard_params(params: nn.Module, mesh) -> nn.Module:
    """This rank's shard of the full ``params`` (see the module
    docstring); ``params`` itself on a mesh of one process."""
    if mesh.single:
        return params
    specs = param_specs(params, mesh)
    shard = _map_leaves(params, lambda n, t: shard_tensor(t, specs[n], mesh))
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
    full = _map_leaves(shard,
                       lambda n, t: gather_tensor(t, specs.get(n, ()), mesh))
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


__all__ = ["Mode", "LinearTP", "shard_tensor", "gather_tensor",
           "shard_tensors", "gather_tensors", "shard_params", "gather_params",
           "tp_of"]
