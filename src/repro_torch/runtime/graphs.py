"""Serve steps captured as CUDA graphs: the port's counterpart of the
reference's compiled steps (the module-level jits of
``repro.serving.engine`` and the ``lax.scan`` of ``LM.generate``).

A :class:`StepGraphs` holds, for each key (the static shapes of one step):

  * static input buffers (:meth:`StepGraphs.stage`), into which the caller
    copies the step's inputs, each by one non-blocking copy from a pinned
    host twin;
  * one ``torch.cuda.CUDAGraph`` of the step, captured on the key's first
    call right after that call has run the step eagerly on a side stream
    (the warm-up, whose result the call returns: first-use work, an
    ``nvcc`` build or a kernel's shared-memory attribute, must not happen
    inside a capture);
  * the capture's static outputs, which every replay overwrites.

A step is a function of no arguments that reads its inputs from the key's
buffers and writes its state (the decode cache) in place.  A replay
re-runs the captured kernels on the same addresses, so every tensor a step
reads or writes must keep its address while its graph lives.  The outputs
hold until the next replay of any graph of the same memory pool: read them
first.

All graphs of one :class:`StepGraphs`, and of those built with its
``pool``, share one memory pool, so a ladder of burst lengths holds one
step's activations rather than one per graph.

Budgets: ``StepGraphs._cache_size()`` is its number of captures.  Each
engine holds its own graphs (they are bound to its cache), where the
reference's engines share one module-level jit; so what an engine declares
to :class:`repro_torch.runtime.compile_guard.CompileGuard` is
:func:`captures` of its step's name, the captures of every
:class:`StepGraphs` of that name in the process, which only grows, as a
jit's cache does.  Declarations then accumulate and release per owner as
the reference's do.

Launch counts: a replay runs no kernel wrapper, so the counts a capture
raised (:func:`repro_torch.kernels.launches`) are taken back off after the
capture and added again on every replay.

Routes: on the CPU, or when built with ``eager=True``, a call runs the step
directly (the CPU route, as the kernels' plain versions are, and the eager
reference on the card).  On CUDA a failed capture raises; it never falls
back to the eager step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Tuple

import numpy as np
import torch

from repro_torch import kernels


def capture_cuda(fn: Callable[[], Any], pool) -> Callable[[], Any]:
    """Capture ``fn()`` into a new CUDA graph drawing on the memory pool
    ``pool``; returns ``replay()``, which replays the graph and returns the
    capture's static outputs.  The capture only records: no kernel runs."""
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernels' C entries query the device and set kernel
    # attributes while they are recorded
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="relaxed"):
        out = fn()

    def replay():
        graph.replay()
        return out
    return replay


# captures by step name, over every StepGraphs of the process
_CAPTURES: Dict[str, int] = {}


class _Captures:
    """The ``_cache_size()`` probe of :func:`captures`."""

    def __init__(self, name: str):
        self.name = name

    def _cache_size(self) -> int:
        return _CAPTURES.get(self.name, 0)


def captures(name: str) -> _Captures:
    """A probe whose ``_cache_size()`` is the number of captures every
    :class:`StepGraphs` named ``name`` has made in this process."""
    return _Captures(name)


@dataclasses.dataclass
class Graph:
    """One captured step: ``replay()`` re-runs it (counting nothing) and
    returns its outputs, ``launches`` are the kernel launches of one replay
    by kernel name.  ``step`` is the captured function, held so that the
    tensors it reads (the cache, the weights) live as long as the graph
    that writes and reads them by address; ``binds`` are the objects the
    caller named as read by the step beyond its key (the weights)."""

    replay: Callable[[], Any]
    launches: Dict[str, int]
    step: Callable[[], Any]
    binds: Tuple[Any, ...] = ()


class StepGraphs:
    """The captured graphs of one serve step, one per key, on ``device``.

    ``name`` names the step (in budgets and errors).  ``pool`` shares the
    memory pool of another cache's graphs.  ``capture(fn, pool) ->
    replay`` captures a step: :func:`capture_cuda` on the graphed route,
    None on the eager one; a test may substitute its own."""

    def __init__(self, name: str, device, *, eager: bool = False, pool=None):
        self.name = name
        self.device = torch.device(device)
        graphed = not eager and self.device.type == "cuda"
        self.capture = capture_cuda if graphed else None
        if pool is None and graphed:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.graphs: Dict[Hashable, Graph] = {}
        self._buffers: Dict[Hashable, Dict[str, torch.Tensor]] = {}
        self._pinned: Dict[Hashable, Dict[str, torch.Tensor]] = {}
        self._held: Dict[Hashable, Any] = {}
        self._staged = None  # event after the last copies out of _pinned

    def _cache_size(self) -> int:
        return len(self.graphs)

    def buffers(self, key: Hashable, **like: np.ndarray) \
            -> Dict[str, torch.Tensor]:
        """The static input buffers of ``key``, made on first use with the
        shapes and dtypes of the host arrays ``like``."""
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = {n: torch.empty(np.shape(a),
                                   dtype=torch.from_numpy(np.asarray(a)).dtype,
                                   device=self.device)
                    for n, a in like.items()}
            self._buffers[key] = bufs
        return bufs

    def held(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """``make()``, kept for ``key`` on the graphed route (a step-invariant
        input the captured graphs read at its address, such as absorbed
        weights; the binds of the graphs that read it tie it to one weight
        tree), and made anew on every call on the eager route."""
        if self.capture is None:
            return make()
        if key not in self._held:
            self._held[key] = make()
        return self._held[key]

    def stage(self, key: Hashable, **arrays: np.ndarray) \
            -> Dict[str, torch.Tensor]:
        """Copy host arrays into ``key``'s static input buffers; returns the
        buffers.  On CUDA each array goes through a pinned host twin, so its
        copy to the card is one non-blocking ``copy_``; a twin is rewritten
        only after the previous copies out of the twins have run."""
        bufs = self.buffers(key, **arrays)
        on_card = self.device.type == "cuda"
        if on_card:
            if self._staged is not None:
                self._staged.synchronize()
            twins = self._pinned.get(key)
            if twins is None:
                twins = {n: torch.empty(b.shape, dtype=b.dtype,
                                        pin_memory=True)
                         for n, b in bufs.items()}
                self._pinned[key] = twins
        for n, a in arrays.items():
            src = torch.from_numpy(np.ascontiguousarray(a))
            if src.shape != bufs[n].shape or src.dtype != bufs[n].dtype:
                raise ValueError(
                    f"{self.name}: input {n!r} of key {key!r} is "
                    f"{src.dtype} {tuple(src.shape)}, its buffer "
                    f"{bufs[n].dtype} {tuple(bufs[n].shape)}")
            if on_card:
                twins[n].copy_(src)
                bufs[n].copy_(twins[n], non_blocking=True)
            else:
                bufs[n].copy_(src)
        if on_card:
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))
        return bufs

    def __call__(self, key: Hashable, fn: Callable[[], Any],
                 binds: Tuple[Any, ...] = ()):
        """Run the step ``fn`` for ``key``: replay its graph, or on the
        key's first call run ``fn`` eagerly (on a side stream on CUDA) and
        capture it; on the eager route run ``fn``.  Returns the step's
        outputs.  ``binds`` are objects ``fn`` reads that the key does not
        name (the weights): a graph replays only with the very objects it
        was captured with, and raises ``ValueError`` otherwise, since the
        replay would read the old ones."""
        if self.capture is None:
            return fn()
        g = self.graphs.get(key)
        if g is not None:
            if len(binds) != len(g.binds) or any(
                    a is not b for a, b in zip(binds, g.binds)):
                raise ValueError(
                    f"{self.name}: key {key!r} was captured with other "
                    f"objects than this call's (a new weight tree?); "
                    f"use a new StepGraphs for them")
            out = g.replay()
            kernels.add_launches(g.launches)
            return out
        out = self._warm_up(fn)
        before = kernels.launches()
        try:
            replay = self.capture(fn, self.pool)
        finally:
            delta = {k: n - before[k] for k, n in kernels.launches().items()
                     if n != before[k]}
            kernels.add_launches({k: -n for k, n in delta.items()})
        self.graphs[key] = Graph(replay, delta, fn, tuple(binds))
        _CAPTURES[self.name] = _CAPTURES.get(self.name, 0) + 1
        return out

    def _warm_up(self, fn):
        if self.device.type != "cuda":
            return fn()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out
