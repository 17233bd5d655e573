"""Meshes of processes (counterpart of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 processes, axes ("data", "model").  Multi-pod:
2 x 16 x 16 = 512, axes ("pod", "data", "model"); only data-parallel
traffic (the adapters' gradient all-reduce, the periodic int8 sync) rides
"pod".  A :class:`Mesh` lays the processes of the default process group
out row-major over its axes ("model" fastest, so a tensor-parallel group
is consecutive ranks) and holds the process groups that the train step,
the sync and the gathers use: "model", "pod", the data-parallel tuple and
that tuple with "model" (the world).  ``init_device_mesh`` would make one
group per axis but none over the data-parallel tuple ("pod", "data"), so
the groups are made here.  A mesh of one process has no process group,
and every collective on it is the identity: ``--mesh cpu`` is the
single-device path unchanged.

The backend is ``nccl`` when each rank has a card of its own, else
``gloo`` (the CPU, and ranks that share one card, which NCCL refuses);
on gloo a collective on a CUDA tensor goes through a host copy, and on
nccl one on a CPU tensor through the rank's card, made explicitly here.
A collective that fails raises (the process group's timeout bounds a
hang).  Under a :class:`repro_torch.perf.cost.CostCounter` each
collective is one operation: its operand's bytes are its collective bytes,
and it reads and writes its operand and result (the reference's HLO
accounting); the tensor-parallel operators of
:mod:`repro_torch.models.tp`, the train step's gradient sums and the
loss's reductions all go through here.

Functions, not module constants: importing this module starts no process
and opens no socket.  :func:`run_ranks` spawns a mesh's processes on one
host (the tests, and ranks that share one card); ``torchrun`` starts them
for :func:`make_production_mesh`.
"""

from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.perf import cost
from repro_torch.sharding.rules import DP_AXES, TP_AXIS

Axes = Tuple[str, ...]
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def world_size() -> int:
    """Processes of the default group (1 when none is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_for(device_type: str, ranks_per_host: int) -> str:
    """``nccl`` when every rank on a host has a card of its own, else
    ``gloo``."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


class Mesh:
    """Named axes over the processes of the default group.

    ``shape`` maps each axis to its size (the reference's ``mesh.shape``),
    ``coords`` this rank's index on each.  :meth:`group` gives the process
    group of an axis or a tuple of axes (None where it has one process),
    and :meth:`all_reduce` / :meth:`all_gather` / :meth:`all_to_all` run
    collectives over it."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh sizes {tuple(sizes)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Axes = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.sizes))
        n, world = math.prod(self.sizes), world_size()
        if n != world:
            raise ValueError(
                f"a mesh of {' x '.join(map(str, self.sizes))} over "
                f"{self.axis_names} wants {n} processes, got {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.coords: Dict[str, int] = {}
        stride = 1
        for name, size in reversed(list(self.shape.items())):
            self.coords[name] = (self.rank // stride) % size
            stride *= size
        # the groups the step, the sync and the gathers use, created here
        # in one order on every rank (``new_group`` is collective)
        self._groups: Dict[Axes, Any] = {}
        for axes in sorted({self._axes(a) for a in (
                TP_AXIS, "pod", self.dp_axes, self.dp_axes + (TP_AXIS,))}):
            self._groups[axes] = self._make_group(axes)

    # ------------------------------------------------------------------

    @property
    def dp_axes(self) -> Axes:
        """The data-parallel axes present, in order."""
        return tuple(a for a in DP_AXES if a in self.shape)

    @property
    def single(self) -> bool:
        return math.prod(self.sizes) == 1

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes, coords=None) -> int:
        """This rank's row-major index over ``axes`` (or, given
        ``coords``, that of the rank at those coordinates)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coords = self.coords if coords is None else coords
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + coords.get(a, 0)
        return i

    def coords_at(self, axes, i: int) -> Dict[str, int]:
        """The coordinates of the rank at row-major index ``i`` over
        ``axes`` whose other coordinates are this rank's."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = dict(self.coords)
        for a in reversed(axes):
            if a in self.shape:
                out[a] = i % self.shape[a]
                i //= self.shape[a]
        return out

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _axes(self, axes) -> Axes:
        """``axes`` (an axis or a tuple) as the mesh's axes among them, in
        the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def _make_group(self, axes: Axes):
        """Creates the groups over ``axes`` (one for each position on the
        other axes) and returns this rank's; None on one process."""
        if self.size(axes) == 1:
            return None
        if self.size(axes) == math.prod(self.sizes):
            return dist.group.WORLD
        rest = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            ranks = [self._rank_of({**base, **dict(zip(axes, v))})
                     for v in itertools.product(
                         *(range(self.shape[a]) for a in axes))]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, axis):
        """This rank's process group over ``axis`` (an axis name or a
        tuple of them, as JAX's ``axis_name``; None: one process)."""
        axes = self._axes(axis)
        if self.size(axes) == 1:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group over {axes}: the mesh makes "
                             f"them over {sorted(self._groups)}")
        return self._groups[axes]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the backend's collectives take it: host
        memory on gloo, this rank's card on nccl, ``t``'s own device under
        the fake group of a dry run."""
        if self.backend == "fake":
            return t.detach().clone()
        if self.backend == "gloo":
            return t.detach().to("cpu", copy=True)
        card = torch.device("cuda", torch.cuda.current_device())
        return t.detach().to(card, copy=True).contiguous()

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum",
                   label: str = ""):
        """A new tensor: ``t`` reduced (``"sum"`` or ``"max"``) over
        ``axes``; ``t`` itself when they hold one process.  A ``label``
        names the collective's role to the cost counter
        (``all_reduce[label]``)."""
        g = self.group(axes)
        if g is None:
            return t
        nbytes = t.numel() * t.element_size()
        with cost.reported(_named("all_reduce", label), 0, 2 * nbytes,
                           nbytes):
            x = self._wire(t)
            dist.all_reduce(x, op=_OPS[op], group=g)
            return x.to(t.device)

    def all_gather(self, t: torch.Tensor, axes, dim: int, label: str = ""):
        """The pieces of ``t`` over ``axes`` concatenated on ``dim``, in
        the axes' row-major order; ``t`` itself on one process (``label``
        as :meth:`all_reduce`'s)."""
        g = self.group(axes)
        if g is None:
            return t
        nbytes = t.numel() * t.element_size()
        with cost.reported(_named("all_gather", label), 0,
                           (1 + self.size(axes)) * nbytes, nbytes):
            x = self._wire(t)
            parts = [torch.empty_like(x) for _ in range(self.size(axes))]
            dist.all_gather(parts, x, group=g)
            return torch.cat(parts, dim=dim).to(t.device)

    def all_to_all(self, t: torch.Tensor, axes):
        """``t``'s rows (dim 0, ``n`` equal blocks for the ``n`` processes
        of ``axes``) exchanged: block i goes to the rank at index i over
        the axes, and the result holds, in index order, the block each
        rank sent here; ``t`` itself on one process."""
        g = self.group(axes)
        if g is None:
            return t
        nbytes = t.numel() * t.element_size()
        with cost.reported("all_to_all", 0, 2 * nbytes, nbytes):
            x = self._wire(t)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x, group=g)
            return y.to(t.device)

    def from_rank0(self, value):
        """Rank 0's ``value`` (any picklable object) on every rank: a
        collective (``value`` itself on one process)."""
        if self.single:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        """Waits for every rank of the mesh (nothing on one process)."""
        if not self.single:
            dist.barrier()

    def describe(self) -> str:
        return (" x ".join(f"{a} {s}" for a, s in self.shape.items())
                + f" (rank {self.rank} of {math.prod(self.sizes)}, backend "
                  f"{self.backend or 'none'})")


def _named(op: str, label: str) -> str:
    return f"{op}[{label}]" if label else op


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the processes of the default group (the counterpart of
    ``jax.make_mesh``)."""
    return Mesh(sizes, axis_names)


# (sizes, axes) of the production meshes, by their ``--mesh`` names
PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 over ("data", "model"), or 2 x 16 x 16 over ("pod",
    "data", "model"); refuses another number of processes."""
    shape, axes = PRODUCTION["multipod" if multi_pod else "pod"]
    world, want = world_size(), math.prod(shape)
    if world != want:
        raise ValueError(
            f"--mesh {'multipod' if multi_pod else 'pod'} is "
            f"{' x '.join(map(str, shape))} over {axes}: it wants {want} "
            f"processes (torchrun --nproc-per-node ... --nnodes ...), got "
            f"{world}")
    return make_mesh(shape, axes)


def make_cpu_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ("data", "model") mesh for CPU and one-host runs; 1 x 1 needs no
    process group."""
    return make_mesh((data, model), ("data", "model"))


def init_from_env(device_type: str, timeout_s: float = 600.0) -> int:
    """Initialises the default group from ``torchrun``'s environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT);
    nothing when WORLD_SIZE is unset or 1.  Returns the local rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if world == 1 or dist.is_initialized():
        return local
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = backend_for(device_type, per_host)
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return local


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device: its own card when there are enough, else the
    card it shares (``cuda:local_rank % count``), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(),
                                                 1))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device_type: str,
               timeout_s: float, inq, out):
    try:
        fn, args = inq.get(timeout=timeout_s)
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend_for(device_type, world), init_method=f"tcp://127.0.0.1:"
            f"{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: a queue would share a tensor's storage with the parent
        # through this process, which exits
        out.put((rank, "ok", pickle.dumps(result)))
    except Exception:  # reported to the parent, which raises
        out.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              device_type: str = "cpu", deadline_s: float = 240.0) -> list:
    """Runs ``fn(rank, *args)`` in ``world`` spawned processes on this
    host, each in the default group (gloo on the CPU and for ranks that
    share a card), and returns their results by rank.  ``fn`` and its
    arguments are pickled (a module-level function), and so are the
    results, by value (tensors on the CPU).  Raises if a rank
    fails, or when ``deadline_s`` passes: then every rank still alive is
    killed."""
    ctx = multiprocessing.get_context("spawn")
    # the function and its arguments go through a queue, whose feeder
    # thread writes them while the ranks start: passed to the Process they
    # would be written to each rank's pipe in turn, the parent waiting for
    # each rank to import torch before starting the next
    inq, out = ctx.Queue(), ctx.Queue()
    for _ in range(world):
        inq.put((fn, args))
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device_type, deadline_s, inq,
                               out)) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    results: Dict[int, Any] = {}
    errors = []
    try:
        while len(results) + len(errors) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world - len(results) - len(errors)} of "
                    f"{world} ranks did not finish within {deadline_s} s")
            try:
                rank, status, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and r not in results]
                if dead and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(
                            f"run_ranks: rank(s) {dead} exited with "
                            f"{[procs[r].exitcode for r in dead]} and no "
                            f"result")
                continue
            if status == "ok":
                results[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=0 if errors else max(end - time.monotonic(), 0.1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("run_ranks: a rank failed\n" + "\n".join(errors))
    return [results[r] for r in range(world)]


__all__ = ["Mesh", "PRODUCTION", "make_mesh", "make_production_mesh",
           "make_cpu_mesh",
           "init_from_env", "rank_device", "backend_for", "run_ranks",
           "world_size"]
