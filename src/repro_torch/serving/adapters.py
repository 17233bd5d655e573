"""AdapterStore: one quantized base, many QA-LoRA adapters (multi-tenant).
Counterpart of ``repro.serving.adapters``.

A group-pooled adapter either merges exactly into the INT-N zeros (the
single-tenant path) or stays separable from the base.  This module serves
the separable side: one device-resident quantized base shared by a fleet
of fine-tunes, with a different adapter applied per engine slot in the
same launch.

Layout: for every quantized linear of the (merged) base the store holds
zero banks ``a [N, L, r]`` and ``b [N, r, D_out]`` with ``N = capacity +
1``; bank row 0 is the reserved null adapter (zeros, delta exactly 0).
The port holds one module per layer, so a bank has no leading stack axis.
:meth:`AdapterStore.with_slot_ids` builds the serving tree, in which every
banked linear is a ``qalora_slot`` linear holding the shared base, both
banks and the per-slot ids; bases and banks are shared by reference.

Unlike the reference, the port writes bank rows in place (``register``,
``evict``) instead of building new arrays: the banks are the store's
largest tensors, and a serving tree built earlier (and a serve step
captured on it) sees the new rows at once, which is what the reference's
rebuild on the next engine step gives.

Capacity and eviction: registering past ``capacity`` evicts the least
recently used adapter that is not live (referenced by a queued or
in-flight request, published by the engine through :meth:`set_live`);
if every resident adapter is live, register fails.  Evicted rows are
zeroed, so a stale id gathers the null adapter, never another tenant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import qalora as qalora_lib
from repro_torch.core.schemes import (LinearParams, QuantPolicy,
                                      adapter_params, get_scheme, map_linears,
                                      merge_tree, quantized_base)


@dataclasses.dataclass
class _Bank:
    """Per-path stacked adapter storage (on the base's device)."""

    a: torch.Tensor       # [N, L, r]
    b: torch.Tensor       # [N, r, D_out]
    policy: QuantPolicy   # the base linear's resolved policy at this path


def extract_pack(params) -> Dict[str, qalora_lib.QALoRAParams]:
    """``path -> QALoRAParams`` of a trained tagged tree, found through the
    schemes' ``trainable_paths``.  Only group-pooled QA-LoRA adapters can
    share a quantized base, so any other trainable scheme raises."""
    pack: Dict[str, qalora_lib.QALoRAParams] = {}

    def fn(path, lp: LinearParams):
        if not get_scheme(lp.scheme).trainable_paths(lp.data):
            return lp
        if lp.scheme != "qalora":
            raise ValueError(
                f"AdapterStore only banks group-pooled QA-LoRA adapters; "
                f"{path!r} holds trainable scheme {lp.scheme!r}")
        pack[path] = adapter_params(lp)
        return lp

    map_linears(params, fn)
    if not pack:
        raise ValueError("no QA-LoRA adapters found in the tree (no scheme "
                         "with trainable paths); is this a merged tree?")
    return pack


class AdapterStore:
    """Named QA-LoRA adapter packs over one shared quantized base.

    ``base_params`` is merged on entry (idempotent for a merged tree), so
    the stored base is the bare INT-N tree every adapter deltas against.
    ``capacity`` is the most adapters registered at once (bank rows =
    capacity + 1).  Each bank has its path's policy dtype."""

    NULL_ID = 0

    def __init__(self, base_params, *, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self.base = merge_tree(base_params)
        self.version = 0          # bumped on every bank mutation
        self.device = None
        self._banks: Dict[str, _Bank] = {}
        self._names: Dict[str, int] = {}
        self._by_id: Dict[int, str] = {}
        self._live: set = set()
        self._tick = 0
        self._last_used: Dict[int, int] = {}
        n = capacity + 1

        def alloc(path, lp: LinearParams):
            if lp.scheme != "intq":
                return lp  # fp linears carry no adapter bank
            qt = quantized_base(lp)
            rank = lp.policy.rank
            if rank < 1:
                raise ValueError(f"base linear {path!r} has policy rank "
                                 f"{rank}; the store needs rank >= 1")
            dt = lp.policy.dtype
            dev = qt.qweight.device
            self.device = dev
            self._banks[path] = _Bank(
                a=torch.zeros((n, qt.n_groups, rank), dtype=dt, device=dev),
                b=torch.zeros((n, rank, qt.d_out), dtype=dt, device=dev),
                policy=lp.policy)
            return lp

        map_linears(self.base, alloc)
        if not self._banks:
            raise ValueError("base tree has no quantized (intq) linears to "
                             "bank adapters over; quantize it first")

    # ---------------- introspection ----------------

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._names)

    @property
    def n_adapters(self) -> int:
        return len(self._names)

    @property
    def bank_bytes(self) -> int:
        """Device bytes of all banks (every row, the null row included)."""
        return sum(t.numel() * t.element_size()
                   for bk in self._banks.values() for t in (bk.a, bk.b))

    def resolve(self, adapter: Union[int, str, None]) -> int:
        """Name or id -> registered id; raises on anything unknown."""
        if adapter is None:
            return self.NULL_ID
        if isinstance(adapter, str):
            if adapter not in self._names:
                raise ValueError(f"unknown adapter {adapter!r}; registered: "
                                 f"{sorted(self._names)}")
            return self._names[adapter]
        aid = int(adapter)
        if aid != self.NULL_ID and aid not in self._by_id:
            raise ValueError(f"unknown adapter id {aid}; registered ids: "
                             f"{sorted(self._by_id)} (0 is the null adapter)")
        return aid

    # ---------------- lifecycle ----------------

    def touch(self, aid: int):
        """LRU bump (the engine calls this when a request binds ``aid``)."""
        if aid in self._by_id:
            self._tick += 1
            self._last_used[aid] = self._tick

    def set_live(self, ids: Iterable[int]):
        """Ids referenced by queued/in-flight requests; LRU eviction and
        :meth:`evict` refuse these."""
        self._live = {int(i) for i in ids if int(i) != self.NULL_ID}

    def _allocate_id(self, name: str) -> int:
        free = [i for i in range(1, self.capacity + 1)
                if i not in self._by_id]
        if free:
            return free[0]
        victims = sorted((i for i in self._by_id if i not in self._live),
                         key=lambda i: self._last_used.get(i, 0))
        if not victims:
            raise RuntimeError(
                f"AdapterStore is full ({self.capacity} adapters) and every "
                f"resident adapter is live (queued or in-flight); cannot "
                f"register {name!r} — drain or raise capacity")
        self.evict(self._by_id[victims[0]])
        return self._allocate_id(name)

    @torch.no_grad()
    def register(self, name: str, trained_params) -> int:
        """Extract ``name``'s adapter pack from a trained tagged tree,
        validate it against the base layout, and write it into a bank row
        (LRU-evicting a non-live adapter when full).  Re-registering an
        existing name overwrites its row in place.  Returns the id."""
        pack = extract_pack(trained_params)
        unknown = sorted(set(pack) - set(self._banks))
        if unknown:
            raise ValueError(
                f"adapter {name!r} carries paths the base does not bank: "
                f"{unknown}; the adapter must be trained against this base")
        for path, ad in pack.items():
            bank = self._banks[path]
            want_a, want_b = tuple(bank.a.shape[1:]), tuple(bank.b.shape[1:])
            if tuple(ad.a.shape) != want_a or tuple(ad.b.shape) != want_b:
                raise ValueError(
                    f"adapter {name!r} at {path!r}: A/B shapes "
                    f"{tuple(ad.a.shape)}/{tuple(ad.b.shape)} do not match "
                    f"the base bank layout {want_a}/{want_b}")
        self._validate_policies(name, trained_params)
        aid = self._names.get(name)
        if aid is None:
            aid = self._allocate_id(name)
            self._names[name] = aid
            self._by_id[aid] = name
        for path, ad in pack.items():
            bank = self._banks[path]
            bank.a[aid].copy_(ad.a.to(bank.a.dtype))
            bank.b[aid].copy_(ad.b.to(bank.b.dtype))
        self.touch(aid)
        self.version += 1
        return aid

    def _validate_policies(self, name: str, trained_params):
        """The adapter's per-path policy (bits, group, scale s) and base
        storage must match the store's, or merged and unmerged serving
        would compute different things."""
        def fn(path, lp: LinearParams):
            bank = self._banks.get(path)
            if bank is None or lp.scheme != "qalora":
                return lp
            bp, ap = bank.policy, lp.policy
            bad = [f"{f}: base={getattr(bp, f)} adapter={getattr(ap, f)}"
                   for f in ("bits", "group_size", "s")
                   if getattr(bp, f) != getattr(ap, f)]
            if bad:
                raise ValueError(
                    f"adapter {name!r} at {path!r} was trained under an "
                    f"incompatible policy ({'; '.join(bad)})")
            qt = quantized_base(lp)
            base_qt = quantized_base(
                self.base.get_submodule(path.replace("/", ".")))
            if qt.qweight.shape != base_qt.qweight.shape:
                raise ValueError(
                    f"adapter {name!r} at {path!r}: trained base storage "
                    f"{tuple(qt.qweight.shape)} != store base "
                    f"{tuple(base_qt.qweight.shape)}")
            return lp

        map_linears(trained_params, fn)

    @torch.no_grad()
    def evict(self, name: str):
        """Drop a registered adapter; refuses live ones.  The bank row is
        zeroed so any stale id gathers the null adapter."""
        if name not in self._names:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{sorted(self._names)}")
        aid = self._names[name]
        if aid in self._live:
            raise RuntimeError(
                f"adapter {name!r} (id {aid}) is live (queued or "
                f"in-flight); drain its requests before evicting")
        for bank in self._banks.values():
            bank.a[aid].zero_()
            bank.b[aid].zero_()
        del self._names[name]
        del self._by_id[aid]
        self._last_used.pop(aid, None)
        self.version += 1

    # ---------------- tree assembly ----------------

    def with_slot_ids(self, slot_ids, out: Optional[torch.Tensor] = None):
        """Serving tree for a slot -> adapter mapping ``[B]`` (host ints).

        Banked linears become ``qalora_slot`` linears holding the shared
        base, both banks and the ids; the ids are checked here, on the
        host, and copied to the device once for the whole tree: into
        ``out`` (``[B]`` int32 on the store's device) when given, which
        the tree then holds, so a tree for a new mapping reads the address
        a captured step reads (the engine's static buffer), else into a new
        tensor."""
        ids = np.asarray(slot_ids).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() > self.capacity):
            raise ValueError(f"slot adapter ids must be in [0, "
                             f"{self.capacity}], got {ids.tolist()}")
        ids = torch.from_numpy(ids.astype(np.int32))
        if out is None:
            ids_d = ids.to(self.device)
        elif out.shape != ids.shape or out.dtype != torch.int32:
            raise ValueError(f"out must be int32 of shape {tuple(ids.shape)},"
                             f" got {out.dtype} {tuple(out.shape)}")
        else:
            ids_d = out.copy_(ids)

        def fn(path, lp: LinearParams):
            bank = self._banks.get(path)
            if bank is None:
                return lp
            data = {"q": quantized_base(lp), "a": bank.a, "b": bank.b,
                    "ids": ids_d}
            return LinearParams(data, scheme="qalora_slot",
                                policy=dataclasses.replace(
                                    lp.policy, mode="qalora_slot"))

        return map_linears(self.base, fn)

    def merged(self, name: Optional[str] = None):
        """Merged single-adapter INT-N tree (the per-request reference):
        zeros update only, :func:`repro_torch.core.qalora.merge` per banked
        path.  ``None`` returns the bare base (null adapter)."""
        if name is None:
            return self.base
        if name not in self._names:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{sorted(self._names)}")
        aid = self._names[name]

        def fn(path, lp: LinearParams):
            bank = self._banks.get(path)
            if bank is None:
                return lp
            ad = qalora_lib.QALoRAParams(bank.a[aid], bank.b[aid])
            qt = qalora_lib.merge(quantized_base(lp), ad, bank.policy.s)
            return LinearParams({"q": qt}, scheme="intq", policy=lp.policy)

        return map_linears(self.base, fn)
