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


class CheckpointManager:
    """Step checkpoints under ``directory/step_<N>/`` plus one ``base/``.

    With ``async_write`` a daemon thread writes each snapshot; a write
    error is raised on the next :meth:`save` or :meth:`wait`."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._async = async_write
        if async_write:
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

    def save(self, step: int, tree, meta: Optional[dict] = None):
        """Snapshot ``tree`` to host memory on this thread, then write it
        (on the writer thread in async mode)."""
        self._raise_pending()
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
        if not is_complete(p):
            save_pytree(to_host(tree), p, meta)

    def wait(self):
        if self._async:
            self._q.join()
        self._raise_pending()

    def all_steps(self):
        return complete_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def step_dir(self, step: int) -> str:
        return step_path(self.dir, step)

    def restore(self, step: int, like=None) -> Dict[str, Any]:
        return load_pytree(self.step_dir(step), like)

    def restore_base(self, like=None) -> Dict[str, Any]:
        return load_pytree(os.path.join(self.dir, "base"), like)

    def close(self):
        if self._async:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=5)
