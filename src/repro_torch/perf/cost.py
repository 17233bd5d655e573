"""The cost of a step as it runs: flops, bytes and collective bytes
(counterpart of ``repro.perf.hlo_analysis``).

The reference walks the compiled HLO text.  The port has no program text:
it counts the operations of one step while they run, under a
:class:`CostCounter` (a ``TorchDispatchMode``), with the reference's
accounting:

  flops            dot and convolution operations only (mm, bmm, addmm,
                   baddbmm, convolution, attention: the formulas of
                   ``torch.utils.flop_counter``); elementwise work is
                   left out, as in MFU-style accounting
  bytes            operands plus results of the operations that move
                   data: products, reductions (softmax, sort and top-k
                   among them), concatenation, padding and copies; a
                   gather or an indexed read counts its result twice, a
                   scatter or an indexed write its update twice (the
                   reference's dynamic-slice and dynamic-update-slice
                   rule).  Elementwise operations, views and allocations
                   count nothing: they fuse into their consumers on the
                   device the roofline models
  collective_bytes operand bytes of every collective

A kernel call is one operation: the entry points of
:mod:`repro_torch.kernels.ops` report their own cost (:func:`reported`,
from the linear scheme's ``flops_bytes`` and the activation's bytes, or
the attention core's) whichever route runs (the kernel on the card, its
plain version on the CPU, shapes alone on ``meta``), and nothing run
inside is counted again.  The mesh's collectives report themselves the
same way.  So one step counts the same integers on the card, on the CPU
and on ``meta``.

Loops: the port walks layers and chunks in Python, so every trip is
counted as it runs (the reference needs the while loop's trip count; the
port has no ``scan_utils``).  A replayed CUDA graph runs no operation
through the dispatcher: count an eager step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "CostCounter", "counting", "reported", "report",
           "tensor_bytes"]


@dataclasses.dataclass
class OpCost:
    flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0

    def __add__(self, o: "OpCost") -> "OpCost":
        return OpCost(self.flops + o.flops, self.bytes + o.bytes,
                      self.collective_bytes + o.collective_bytes)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (in nested lists, tuples and
    dicts too)."""
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            n += tensor_bytes(*t)
        elif isinstance(t, dict):
            n += tensor_bytes(*t.values())
    return n


# aten operations by how they move data (overload packet names)
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
             "convolution_backward", "_scaled_dot_product_flash_attention",
             "_scaled_dot_product_flash_attention_for_cpu",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_cudnn_attention"}
_MOVES = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
          "prod", "logsumexp", "var", "std", "var_mean", "linalg_vector_norm",
          "norm", "cumsum", "cumprod", "_softmax", "_log_softmax",
          "_softmax_backward_data", "_log_softmax_backward_data", "sort",
          "topk", "cat", "constant_pad_nd", "clone"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# scatters: the position of the update among the tensor arguments
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
             "scatter_reduce": 3, "index_copy": 3, "index_copy_": 3,
             "index_add": 3, "index_add_": 3, "slice_scatter": 1,
             "select_scatter": 1, "masked_scatter": 2, "copy_": 1}


def op_cost(func, args, kwargs, out) -> OpCost:
    """The cost of one aten operation under the rules above."""
    name = func._overloadpacket.__name__
    flops = 0
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
        flops = int(formula(*args, **kwargs, out_val=out))
    if name in _PRODUCTS or name in _MOVES:
        nbytes = tensor_bytes(args, kwargs, out)
    elif name in _GATHERS:
        nbytes = 2 * tensor_bytes(out)
    elif name in _SCATTERS:
        pos = _SCATTERS[name]
        upd = args[pos] if len(args) > pos else None
        nbytes = 2 * (tensor_bytes(upd) if isinstance(upd, torch.Tensor)
                      else tensor_bytes(out))
    else:
        nbytes = 0
    return OpCost(flops, nbytes)


_ACTIVE: List["CostCounter"] = []
_LOCAL = threading.local()


def _suppressed() -> bool:
    return getattr(_LOCAL, "depth", 0) > 0


class _Uncacheable(Exception):
    pass


def _key(a, metas: list):
    """A hashable key of an argument: a ``meta`` tensor by its metadata
    (counted in ``metas``), a wrapped Python number by its dtype alone,
    containers item by item, anything else as itself."""
    if isinstance(a, torch.Tensor):
        if a.device.type == "meta":
            metas.append(1)
            return (tuple(a.shape), a.stride(), a.dtype)
        if a.dim() == 0 and a.device.type == "cpu":
            return ("0-d", a.dtype)  # a Python number, wrapped
        raise _Uncacheable
    if isinstance(a, (list, tuple)):
        return tuple(_key(x, metas) for x in a)
    return a


class _Meta(NamedTuple):
    """The layout of a ``meta`` result."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _spec(out):
    if isinstance(out, torch.Tensor):
        return _Meta(tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return type(out)(_spec(x) for x in out)
    if out is None:
        return None
    raise _Uncacheable


def _rebuild(spec):
    if isinstance(spec, _Meta):
        return torch.empty_strided(spec.shape, spec.stride, dtype=spec.dtype,
                                   device="meta")
    if isinstance(spec, (list, tuple)):
        return type(spec)(_rebuild(x) for x in spec)
    return None


def _functional(func) -> bool:
    """Whether ``func`` neither writes an argument nor returns a view."""
    sch = func._schema
    return not sch.is_mutable and all(r.alias_info is None
                                      for r in sch.returns)


class CostCounter(TorchDispatchMode):
    """Counts every operation dispatched while it is active (the
    backward's too) into :attr:`cost`; :attr:`by_op` keeps a tally per
    operation name (``[calls, flops, bytes, collective bytes]``), with the
    reported kernel calls and collectives under their own names.

    On ``meta`` tensors a functional operation's result and cost are
    remembered by the operation and its arguments' shapes, strides and
    dtypes, and an operation seen before gets fresh ``meta`` results of
    that layout without running again: PyTorch's ``meta`` versions of
    elementwise operations run in Python, and a full-width prefill repeats
    the same attention chunk's operations thousands of times."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.by_op: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0, 0, 0])
        self._memo: Dict[tuple, tuple] = {}

    def add(self, name: str, c: OpCost):
        self.cost = self.cost + c
        row = self.by_op[name]
        row[0] += 1
        row[1] += c.flops
        row[2] += c.bytes
        row[3] += c.collective_bytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if (args or kwargs) and _functional(func):
            metas = []
            try:
                key = (func, _key(args, metas),
                       _key(tuple(kwargs.items()), metas))
            except _Uncacheable:
                pass
            key = key if metas else None
        if key is not None and key in self._memo:
            spec, c = self._memo[key]
            out = _rebuild(spec)
        else:
            out = func(*args, **kwargs)
            c = op_cost(func, args, kwargs, out)
            if key is not None:
                try:
                    self._memo[key] = (_spec(out), c)
                except _Uncacheable:
                    pass
        if (c.flops or c.bytes) and not _suppressed():
            self.add(func._overloadpacket.__name__, c)
        return out


def counting() -> bool:
    """Whether a counter is active (callers skip computing a cost when
    not)."""
    return bool(_ACTIVE)


def report(name: str, flops: int = 0, nbytes: int = 0,
           collective_bytes: int = 0) -> None:
    """Adds one operation's cost (plain ints) to every active counter
    (none: a no-op), unless it runs inside another reported operation."""
    if _ACTIVE and not _suppressed():
        c = OpCost(flops, nbytes, collective_bytes)
        for counter in _ACTIVE:
            counter.add(name, c)


@contextlib.contextmanager
def reported(name: str, flops: int = 0, nbytes: int = 0,
             collective_bytes: int = 0):
    """One operation of the given cost (:func:`report`); nothing
    dispatched inside the block is counted again."""
    report(name, flops, nbytes, collective_bytes)
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1
