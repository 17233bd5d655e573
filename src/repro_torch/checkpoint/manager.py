"""Async, atomic checkpointing of nested dicts of tensors (counterpart of
``repro.checkpoint.manager``).

* QA-LoRA makes the base model **immutable**: it is written once at job
  start (the ``base`` snapshot) and never again; per-step checkpoints hold
  only the adapters, the optimizer state and the data cursor.
* **Async**: :meth:`CheckpointManager.save` copies every tensor to host
  memory on the caller's thread (so the next step may overwrite the
  parameters in place), then a writer thread serialises the copy.
* **Atomic**: writes go to ``step_N.tmp/`` and ``os.replace`` to
  ``step_N/``; the manifest is written last, so a directory without one
  is a torn write, never restored, and reaped.
* Retention keeps the newest ``keep`` checkpoints.
* **Elastic**: on a mesh of processes (``mesh``, ``specs``: each rank
  holds its shard of the tensors named in ``specs``) a save gathers the
  full tensors on every rank and rank 0 writes them; a restore reads the
  full tensors and slices this rank's blocks.  So a checkpoint written on
  one mesh restores onto any other, or onto one process.  The directory
  must be on a file system that every rank shares: rank 0 decides what
  is there (the latest step, whether the base is written) for all ranks,
  and a restore that some rank cannot read is refused on every rank.

On disk: ``leaves.npz`` (leaf ``i`` as ``l<i>``; bf16 as its uint16 bit
pattern), ``treedef.json`` (each leaf's key path and dtype name) and
``manifest.json`` (with an optional ``meta`` record the writer chose).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

# torch dtypes numpy has no type for: stored as their 16-bit pattern
_AS_UINT16 = (torch.bfloat16,)


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint keys must be str, got {k!r}")
            out += _flatten(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def to_host(tree):
    """A copy of ``tree`` with every tensor copied to host memory (a CUDA
    copy waits for the device; a CPU tensor is cloned, so later in-place
    updates do not reach the copy)."""
    return _unflatten((p, x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else x)
                      for p, x in _flatten(tree))


def is_complete(path: str) -> bool:
    """A checkpoint dir is valid iff its manifest exists: the manifest is
    written LAST, so a torn dir (crash mid-write) is never mistaken for a
    valid checkpoint."""
    return os.path.exists(os.path.join(path, MANIFEST))


def save_pytree(tree, path: str, meta: Optional[dict] = None):
    """Synchronous atomic write of a nested dict of tensors (or numpy
    arrays) to ``path/``; ``meta`` (JSON) goes into the manifest, which is
    written last inside the staging dir."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, paths, dtypes = {}, [], []
    for i, (p, x) in enumerate(_flatten(tree)):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu()
            dtypes.append(str(t.dtype).replace("torch.", ""))
            if t.dtype in _AS_UINT16:
                a = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            else:
                a = t.numpy()
        else:
            a = np.asarray(x)
            dtypes.append("numpy." + a.dtype.name)
        arrays[f"l{i}"] = a
        paths.append(list(p))
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    with open(os.path.join(tmp, "treedef.json"), "w") as f:
        json.dump({"paths": paths, "n": len(paths), "dtypes": dtypes}, f)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"complete": True, "n": len(paths), "meta": meta or {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def read_meta(path: str) -> dict:
    """The ``meta`` record of a complete checkpoint."""
    _require_complete(path)
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f).get("meta", {})


def _require_complete(path: str):
    if not is_complete(path):
        raise ValueError(
            f"torn/incomplete checkpoint at {path!r}: no {MANIFEST} (the "
            f"manifest is written last; a dir without one is a partial "
            f"write and must not be restored)")


def load_pytree(path: str, like=None) -> dict:
    """Restore a nested dict of CPU tensors (numpy leaves come back as
    numpy).  With ``like`` (a nested dict of tensors), the checkpoint must
    hold the same key paths, shapes and dtypes, and each tensor is placed
    on its ``like`` leaf's device; any difference raises ValueError."""
    _require_complete(path)
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    items = []
    with np.load(os.path.join(path, "leaves.npz")) as z:
        for i, (p, name) in enumerate(zip(meta["paths"], meta["dtypes"])):
            a = z[f"l{i}"]
            if name.startswith("numpy."):
                items.append((tuple(p), a))
                continue
            dtype = getattr(torch, name)
            if dtype in _AS_UINT16:
                t = torch.from_numpy(a.view(np.int16)).view(dtype)
            else:
                t = torch.from_numpy(a)
            items.append((tuple(p), t))
    tree = _unflatten(items)
    return tree if like is None else conform(tree, like, path)


def conform(tree: dict, like: dict, where: str = "checkpoint") -> dict:
    """``tree`` checked against ``like`` (the same key paths, shapes and
    dtypes, else ValueError naming ``where``), each tensor moved to its
    ``like`` leaf's device."""
    want = dict(_flatten(like))
    got = dict(_flatten(tree))
    if set(want) != set(got):
        diff = sorted("/".join(p) for p in set(want) ^ set(got))
        raise ValueError(f"{where!r} does not match the model's structure: "
                         f"{len(diff)} key paths differ, e.g. {diff[:4]}")
    out = []
    for p, ref in want.items():
        t = got[p]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"{where!r} at {'/'.join(p)}: {tuple(t.shape)} {t.dtype}, "
                f"the model has {tuple(ref.shape)} {ref.dtype}")
        out.append((p, t.to(ref.device)))
    return _unflatten(out)


def complete_steps(directory: str) -> List[int]:
    """The steps of ``directory`` whose checkpoints are complete."""
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and is_complete(os.path.join(directory, d)))


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _by_dict(tree, fn):
    """``tree`` (a tree of ``{name: tensor}`` dicts, e.g. ``{"t": ...,
    "o": {"mu": ..., "nu": ..., "step": ...}}``) with each dict's tensor
    leaves replaced by ``fn({name: tensor})`` (which may name other
    leaves: a rank's experts in, every expert out), in one order on every
    rank."""
    groups: Dict[Tuple[str, ...], dict] = {}
    for p, x in _flatten(tree):
        groups.setdefault(p[:-1], {})[p[-1]] = x
    items = []
    for parent, leaves in groups.items():
        tensors = {k: x for k, x in leaves.items()
                   if isinstance(x, torch.Tensor)}
        done = fn(tensors)
        items += [(parent + (k,), x) for k, x in leaves.items()
                  if k not in tensors]
        items += [(parent + (k,), x) for k, x in done.items()]
    return _unflatten(items)


class CheckpointManager:
    """Step checkpoints under ``directory/step_<N>/`` plus one ``base/``.

    With ``async_write`` a daemon thread writes each snapshot; a write
    error is raised on the next :meth:`save` or :meth:`wait`.  With a
    ``mesh`` of more than one process the trees saved and restored are
    this rank's shards under ``specs`` (leaf name -> spec): every rank
    calls :meth:`save` (a gather), :meth:`save_base`, :meth:`latest_step`
    and :meth:`restore` (each a collective), and only rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True,
                 mesh=None, specs: Optional[dict] = None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh if mesh is not None and not mesh.single else None
        self.specs = specs or {}
        self._writer = self.mesh is None or self.mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._async = async_write and self._writer
        if self._async:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, meta = item
            try:
                save_pytree(host_tree, self.step_dir(step), meta)
                self._gc()
            except Exception as e:  # surfaced on the next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        # torn dirs (no manifest: a crashed writer) are dead weight:
        # all_steps() never returns them, so reap them here
        for d in os.listdir(self.dir):
            p = os.path.join(self.dir, d)
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and os.path.isdir(p) and not is_complete(p)):
                shutil.rmtree(p, ignore_errors=True)

    def _raise_pending(self):
        if self._err is not None:
            raise self._err

    # ------------------------------------------------------------------

    def _gathered(self, tree):
        if self.mesh is None:
            return tree
        from repro_torch.sharding.shard import gather_tensors
        return _by_dict(tree, lambda d: gather_tensors(d, self.specs,
                                                       self.mesh))

    def save(self, step: int, tree, meta: Optional[dict] = None):
        """Snapshot ``tree`` to host memory on this thread, then write it
        (on the writer thread in async mode)."""
        self._raise_pending()
        tree = self._gathered(tree)
        if not self._writer:
            return
        host = to_host(tree)
        if self._async:
            self._q.put((step, host, meta))
        else:
            save_pytree(host, self.step_dir(step), meta)
            self._gc()

    def save_base(self, tree, meta: Optional[dict] = None):
        """One-time immutable base-model snapshot (the quantized weights):
        a later call finds it and writes nothing."""
        p = os.path.join(self.dir, "base")
        if not self._from_rank0(is_complete(p)):
            tree = self._gathered(tree)
            if self._writer:
                save_pytree(to_host(tree), p, meta)

    def wait(self):
        if self._async:
            self._q.join()
        self._raise_pending()

    def all_steps(self):
        return complete_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        """The newest complete step.  On a mesh it is the one rank 0
        finds, refused on every rank if some rank cannot read it."""
        s = self.all_steps() if self._writer else None
        step = self._from_rank0(s[-1] if s else None)
        if self.mesh is None or step is None:
            return step
        unread = int(self.mesh.all_reduce(torch.tensor(
            0 if is_complete(self.step_dir(step)) else 1),
            self.mesh.axis_names))
        if unread:
            raise ValueError(
                f"{unread} of {self.mesh.size(self.mesh.axis_names)} ranks "
                f"cannot read {self.step_dir(step)!r}: the checkpoint "
                f"directory of a mesh must be on a file system that every "
                f"rank shares")
        return step

    def _from_rank0(self, value):
        return value if self.mesh is None else self.mesh.from_rank0(value)

    def step_dir(self, step: int) -> str:
        return step_path(self.dir, step)

    def restore(self, step: int, like=None) -> Dict[str, Any]:
        """The tree of step ``step``, checked against ``like`` (this
        rank's blocks of it on a mesh)."""
        if self.mesh is None:
            return load_pytree(self.step_dir(step), like)
        from repro_torch.sharding.shard import shard_tensors
        tree = _by_dict(load_pytree(self.step_dir(step)),
                        lambda d: shard_tensors(d, self.specs, self.mesh))
        return tree if like is None else conform(tree, like,
                                                 self.step_dir(step))

    def restore_base(self, like=None) -> Dict[str, Any]:
        return load_pytree(os.path.join(self.dir, "base"), like)

    def close(self):
        if self._async:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=5)
