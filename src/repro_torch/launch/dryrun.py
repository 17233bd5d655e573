"""Multi-pod dry run of the port: every (architecture x input shape x mesh)
cell built as one rank's program and counted on the ``meta`` device
(counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell under the production sharding
over 512 host devices and reads the compiled program.  The port needs no
device: a rank's program runs on ``meta`` tensors (shapes only, nothing
allocated) under a fake process group of the mesh's world size
(``torch.testing._internal.distributed.fake_pg``, collectives that move
nothing), on the rank's shard of the full-width params
(:func:`repro_torch.sharding.shard_params` by
:func:`~repro_torch.sharding.param_specs`; linears ``col``, ``row`` or
``whole``), its rows of the batch
(:func:`~repro_torch.sharding.batch_spec_tree`) and its part of the
decode cache (:func:`~repro_torch.sharding.cache_part` under
:func:`~repro_torch.sharding.cache_spec_tree`).  Train cells run
:func:`repro_torch.launch.steps.make_train_step`, prefill cells
``LM.prefill``, decode cells :func:`~repro_torch.launch.steps.
make_decode_step`'s step (``--gen-len N``: ``make_generate_step``'s N
tokens, N - 1 steps and their greedy argmax, the serve loop's program).
One step is counted by :class:`repro_torch.perf.cost.CostCounter`: a MoE
layer's expert dispatch and combine count as the mesh's all-to-all and
all-gather, a decode step's partial-score sums over "model", log-sum-exp
merges over the data axes and MLA's latent gathers as labelled
all-reduces and all-gathers, and a rank's expert bytes are its experts'
only.  A cell the port does not run on a mesh (``check_mesh_support``,
and for an mla_moe prefill whose compressed cache is not the rank's part
``check_prefill_mesh_support``) is recorded as refused with the
reason.

Each cell writes ``<outdir>/<arch>__<cell>__<mesh>.json``: the rank's
bytes of params, optimizer state, cache and batch (what it holds before
the step's activations), whether they fit in the card's memory, the
counted cost of one step, and the seconds the cell took.  Existing
records are kept unless ``--force``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --cell decode_32k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.roofline_report
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import PRODUCTION as MESHES
from repro_torch.perf.cost import CostCounter, tensor_bytes
from repro_torch.perf.roofline import HW

OUTDIR = "experiments/dryrun_torch"


@contextlib.contextmanager
def fake_mesh(sizes: Sequence[int], names: Sequence[str], rank: int = 0):
    """A mesh of ``prod(sizes)`` processes of which this one is ``rank``,
    over a fake process group (no other process, no device); the group is
    destroyed on exit.  A mesh of one process needs no group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    world = math.prod(sizes)
    if world > 1:
        if dist.is_initialized():
            raise RuntimeError("a process group is already initialised")
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    try:
        yield make_mesh(sizes, names)
    finally:
        if world > 1:
            dist.destroy_process_group()


def build_config(arch: str, policy: str = "", reduced: bool = False):
    import repro_torch.configs as C
    cfg = C.reduced(arch) if reduced else C.get(arch)
    if policy:
        from repro_torch.core.schemes import PolicyTree
        cfg = cfg.scaled(quant=PolicyTree.parse(policy,
                                                base=cfg.quant.default))
    return cfg


def _rows(mesh, n: int) -> Tuple[int, int]:
    """(first row, row count) of this rank's block of ``n`` batch rows:
    split over the data-parallel axes where they divide, else all."""
    dp = mesh.dp_axes
    if not dp or n % mesh.size(dp):
        return 0, n
    size = n // mesh.size(dp)
    return mesh.index(dp) * size, size


def check_prefill_mesh_support(cfg, cache, mesh, rows: int) -> None:
    """Raises NotImplementedError (naming ROADMAP.md) where an mla_moe
    prefill's compressed cache on this rank (each leaf [L, B, S, R]) is
    not its part under :func:`~repro_torch.sharding.cache_spec_tree` of
    the global batch's ``rows``."""
    from repro_torch.launch.steps import MESH_NOT_PORTED
    from repro_torch.sharding import cache_spec_tree, padded
    if cfg.family != "mla_moe":
        return
    width = {"c": cfg.kv_lora_rank, "kr": cfg.qk_rope_dim}
    for part, leaves in cache["layers"].items():
        for name, t in leaves.items():
            full = (t.shape[0], rows, t.shape[2], width[name])
            spec = padded(cache_spec_tree({name: full}, mesh)[name], 4)
            want = tuple(n // mesh.size(a) if a else n
                         for n, a in zip(full, spec))
            if tuple(t.shape) != want:
                raise NotImplementedError(
                    f"{cfg.name}'s prefill writes a rank's {part} {name} "
                    f"cache {tuple(t.shape)}, its cache spec {spec} holds "
                    f"{want}; prefill with that cache layout is "
                    f"{MESH_NOT_PORTED}")


def make_step(lm, kind: str, params, inputs: Dict, mesh=None,
              opt_state=None, gen_len: int = 0):
    """A callable running one step of ``kind`` on ``params`` (this rank's
    shard on ``mesh``), on whatever device the tensors are: ``train``
    (the train step, AdamW included; ``inputs["batch"]`` the global
    batch), ``prefill`` (``inputs["batch"]`` this rank's rows) or
    ``decode`` (``inputs["cache"]``, ``inputs["tokens"]``: the full cache
    and tokens, of which the step takes this rank's part and rows;
    ``gen_len`` > 0 runs ``make_generate_step``'s ``gen_len - 1`` steps,
    each fed the argmax of the last)."""
    from repro_torch.launch.steps import (make_decode_step,
                                          make_generate_step,
                                          make_train_step)
    from repro_torch.models import moe
    from repro_torch.optim import adamw_init, trainable_tensors
    from repro_torch.sharding import cache_part, decode_layout
    if kind == "train":
        step = make_train_step(lm, mesh)
        opt = opt_state if opt_state is not None else \
            adamw_init(trainable_tensors(params))
        return lambda: step(params, opt, inputs["batch"])

    if kind == "prefill":
        @torch.no_grad()
        def prefill():
            with moe.rows_over(inputs.get("rows", ())):
                return lm.prefill(params, inputs["batch"])
        return prefill
    cache, tokens = inputs["cache"], inputs["tokens"]
    part = cache
    if mesh is not None and not mesh.single:
        part = cache_part(cache, mesh)
        rows = decode_layout(cache, mesh).rows
        n = tokens.shape[0] // mesh.size(rows)
        tokens = tokens[mesh.index(rows) * n:(mesh.index(rows) + 1) * n]
    if gen_len:
        gen, _ = make_generate_step(lm, mesh, gen_len)(cache)
        cols = lm.cfg.vocab // (mesh.size("model") if mesh else 1)
        # the first token's logits: zeros of this rank's rows and columns
        logits = torch.zeros((tokens.shape[0], cols), device=tokens.device)
        return lambda: gen(params, part, logits)
    step, _ = make_decode_step(lm, mesh)(cache)
    return lambda: step(params, part, tokens)


def run_step(lm, kind: str, params, inputs: Dict, mesh=None, opt_state=None,
             gen_len: int = 0, out: Optional[list] = None) -> CostCounter:
    """One step of :func:`make_step` under a :class:`CostCounter`;
    returns the counter (and appends the step's result to ``out``)."""
    step = make_step(lm, kind, params, inputs, mesh, opt_state, gen_len)
    with CostCounter() as counter:
        result = step()
    if out is not None:
        out.append(result)
    return counter


def trace(cfg, cell, mesh=None, gen_len: int = 0) -> dict:
    """One rank's program of ``cell`` for ``cfg`` on ``mesh`` (None: one
    device), built and counted on ``meta``: ``{"cost", "by_op",
    "memory"}``.  Raises NotImplementedError where the port does not run
    the cell on the mesh."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.launch.steps import abstract_params, check_mesh_support
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw_init, trainable_tensors
    from repro_torch.sharding import batch_spec_tree, cache_part, \
        rank_param_bytes, shard_params, shard_tensors
    lm = LM(cfg)
    sharded = mesh is not None and not mesh.single
    if sharded:
        # before the full-width params are built (a refused cell costs
        # nothing): the family, then the schemes of one layer of each
        # stack (a policy names no layer)
        check_mesh_support(cfg, mesh=mesh)
    params = abstract_params(lm)
    held = {"params_bytes": rank_param_bytes(params, mesh) if sharded
            else tensor_bytes(*params.buffers(), *params.parameters()),
            "opt_bytes": 0, "cache_bytes": 0, "batch_bytes": 0}
    if sharded:
        params = shard_params(params, mesh)
    kind, inputs = input_specs(cfg, cell)
    opt = None
    if kind == "train":
        opt = adamw_init(trainable_tensors(params))
        held["opt_bytes"] = tensor_bytes(opt)
    if "batch" in inputs:
        batch = inputs["batch"]
        local = shard_tensors(batch, batch_spec_tree(batch, mesh), mesh) \
            if sharded else batch
        held["batch_bytes"] = tensor_bytes(local)
        if kind == "prefill":
            rows = int(batch["tokens"].shape[0])
            inputs = {"batch": local, "rows": mesh.dp_axes if sharded and
                      _rows(mesh, rows)[1] < rows else ()}
    else:
        part = cache_part(inputs["cache"], mesh) if sharded \
            else inputs["cache"]
        held["cache_bytes"] = tensor_bytes(part)
        held["batch_bytes"] = tensor_bytes(inputs["tokens"]) * \
            part["len"].shape[0] // cell.global_batch
    result = []
    counter = run_step(lm, kind, params, inputs, mesh if sharded else None,
                       opt, gen_len=gen_len, out=result)
    if kind == "prefill" and sharded:
        check_prefill_mesh_support(cfg, result[0][1], mesh,
                                   int(batch["tokens"].shape[0]))
    total = sum(held.values())
    return {"cost": counter.cost.as_dict(),
            "by_op": {k: dict(zip(("calls", "flops", "bytes",
                                   "collective_bytes"), v))
                      for k, v in sorted(counter.by_op.items())},
            "memory": {**held, "total_bytes": total,
                       "fits": total <= HW().hbm_bytes}}


def cell_tag(arch: str, cell_name: str, mesh_kind: str, gen_len: int = 0,
             policy: str = "", reduced: bool = False) -> str:
    tag = f"{arch}__{cell_name}__{mesh_kind}"
    if gen_len:
        tag += f"__gen{gen_len}"
    if reduced:
        tag += "__reduced"
    if policy:
        digest = hashlib.sha1(policy.encode()).hexdigest()[:8]
        tag += "__pol" + re.sub(r"[^A-Za-z0-9]+", "-", policy)[:40] + "-" \
            + digest
    return tag


def run_cell(arch: str, cell_name: str, mesh_kind: str, outdir: str = OUTDIR,
             force: bool = False, gen_len: int = 0, policy: str = "",
             reduced: bool = False, mesh: Optional[Tuple] = None) -> dict:
    """Builds, counts and records one cell as rank 0 of the
    ``mesh_kind`` production mesh (``mesh``: a ``(sizes, names)`` mesh in
    its place, e.g. a small one for a reduced config)."""
    from repro_torch.configs.base import SHAPES
    cell = SHAPES[cell_name]
    if cell.kind != "decode":
        gen_len = 0  # only decode cells have a generation program
    tag = cell_tag(arch, cell_name, mesh_kind, gen_len, policy, reduced)
    path = os.path.join(outdir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    sizes, names = mesh or MESHES[mesh_kind]
    t0 = time.time()
    rec = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
           "mesh_shape": dict(zip(names, sizes)), "rank": 0,
           "n_devices": math.prod(sizes), "gen_len": gen_len,
           "policy": policy, "reduced": reduced}
    cfg = build_config(arch, policy, reduced)
    with fake_mesh(sizes, names) as m:
        try:
            rec.update(trace(cfg, cell, m, gen_len=gen_len))
            rec.update(ok=True, status="ok")
        except NotImplementedError as e:
            rec.update(ok=False, status="refused", reason=str(e))
    rec["seconds"] = time.time() - t0
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["ok"]:
        mem = rec["memory"]
        print(f"[dryrun] OK  {tag}  {rec['seconds']:.1f}s "
              f"held={mem['total_bytes'] / 2**30:.2f}GiB "
              f"fits={mem['fits']} flops={rec['cost']['flops']:.3e} "
              f"bytes={rec['cost']['bytes']:.3e} "
              f"coll={rec['cost']['collective_bytes']:.3e}", flush=True)
    else:
        print(f"[dryrun] REFUSED {tag}: {rec['reason']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--gen-len", type=int, default=0,
                    help="decode cells: the serve loop's gen_len - 1 steps "
                         "in place of one decode step")
    ap.add_argument("--policy", default="",
                    help='per-layer policy rules, e.g. '
                         '"*=int4,*/attn/wo=int8,lm_head=fp"')
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU smoke) config sizes")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    if args.all:
        jobs = [(a, c.name) for a in C.ASSIGNED for c in C.cells_for(a)]
    elif args.arch and args.cell:
        jobs = [(args.arch, args.cell)]
    else:
        ap.error("give --arch and --cell, or --all")
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    t0 = time.time()
    failures, refused = [], 0
    for arch, cell in jobs:
        for mk in meshes:
            try:
                rec = run_cell(arch, cell, mk, args.outdir, force=args.force,
                               gen_len=args.gen_len, policy=args.policy,
                               reduced=args.reduced)
                refused += not rec["ok"]
            except Exception as e:  # a fault: reported, the rest go on
                failures.append((arch, cell, mk, repr(e)))
                print(f"[dryrun] FAIL {arch}__{cell}__{mk}: {e}")
                traceback.print_exc()
    n = len(jobs) * len(meshes)
    print(f"[dryrun] {n} cells in {time.time() - t0:.1f}s: "
          f"{n - refused - len(failures)} ok, {refused} refused, "
          f"{len(failures)} failed")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
