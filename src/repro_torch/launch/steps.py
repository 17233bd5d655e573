"""The QA-LoRA train step and the decode steps on a mesh (counterpart of
``make_train_fn``, ``make_train_step``, ``train_state_specs``,
``make_decode_step``, ``make_generate_step`` and ``make_sync_step`` in
``repro.launch.steps``).

Gradients flow ONLY to the adapters: the quantized base is a set of
buffers, so autograd builds no gradient for it and the optimizer keeps no
state for it.  On CUDA every ``qalora`` linear's forward is kernel 3
(with its rank projection) through ``ops._QALoRAMatmul``, launched again
in the backward when ``cfg.remat`` recomputes the block; the backward
itself is plain PyTorch.  A gqa_moe model's loss carries ``cfg.aux_coef``
times the router's load-balance term, and its expert adapters train with
the rest.

On a mesh of processes (:func:`make_train_step`) each rank holds its
shard (:func:`repro_torch.sharding.shard_params`) and computes what
GSPMD computes for the reference's single-device step: the masked mean
``loss_sum / max(n, 1)`` over the global batch and the clip over the
global norm.  Its batch rows are its block of the global batch over the
data-parallel axes (the whole batch where they do not divide it); the
model's tensor-parallel forward is :mod:`repro_torch.models.tp`.  After
the backward, the gradients that are partial sums over "model" (a column
linear's replicated A, whose gradient contracts over the sharded output;
a row linear's replicated B, whose input is a partial sum) are summed
over "model", and every gradient over the data-parallel axes its leaf is
not split over (:func:`grad_sum_axes`): an expert held by one rank of
the whole mesh (full expert parallelism) computed every slot of its
expert and is summed over none, one split over "model" alone over the
data-parallel axes.  The MoE layers route the global batch
(:mod:`repro_torch.models.moe`; their aux term each rank's share of the
global one).  The gqa, gqa_moe and mla_moe families in ``--mode
qalora`` are ported on a mesh; the rest are refused (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import torch

from repro_torch.core import schemes
from repro_torch.models import moe
from repro_torch.models import tp as tpm
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compressed_mean
from repro_torch.optim.partition import split_params, trainable_tensors
from repro_torch.sharding import (batch_spec_tree, cache_spec_tree,
                                  check_cache_part, decode_layout,
                                  param_specs, shard_tensors)
from repro_torch.sharding.shard import Mode, tp_of

MESH_NOT_PORTED = ("not yet ported on a mesh (see ROADMAP.md, Queue 1 item "
                   "16c): only the gqa, gqa_moe and mla_moe families in "
                   "--mode qalora train on a mesh")
MESH_FAMILIES = ("gqa", "gqa_moe", "mla_moe")


def make_train_fn(lm: LM, opt_cfg: AdamWConfig):
    """Returns ``train_step(params, opt_state, batch) -> metrics``: the
    loss, the backward over the trainable tensors only, then
    :func:`adamw_update` in place on ``params``' adapters and
    ``opt_state``.  Metrics (f32 device scalars): ``loss``, ``xent``,
    ``aux``, ``grad_norm`` and ``lr``."""

    def train_step(params, opt_state, batch):
        trainable = trainable_tensors(params)
        loss, metrics = lm.loss(params, batch)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        om = adamw_update(opt_cfg, dict(zip(trainable, grads)), opt_state,
                          trainable)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def model_schemes(cfg) -> Set[str]:
    """The linear schemes of ``cfg``'s model, read from one layer of each
    stack built on ``meta`` (a policy names no layer)."""
    cut = {"n_layers": 1}
    if cfg.family == "mla_moe":
        cut = {"n_layers": 2, "n_dense_layers": 1}
    one = abstract_params(LM(cfg.scaled(**cut)))
    return {lp.scheme for lp in one.modules() if schemes.is_linear(lp)}


def check_mesh_support(cfg, schemes_used=None, mesh=None) -> None:
    """Raises NotImplementedError, naming ROADMAP.md, for what does not
    train on a mesh yet: a family other than gqa, gqa_moe and mla_moe, a
    tied embedding, a vocabulary that does not split over ``mesh``'s
    "model" axis (the reference then replicates the head and splits the
    embedding over d), a linear of another adapter scheme than qalora.
    ``schemes_used`` defaults to :func:`model_schemes`'s; ``mesh`` may be
    a mapping of axis sizes."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): "
                                  f"{MESH_NOT_PORTED}")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}'s tied embedding: "
                                  f"{MESH_NOT_PORTED}")
    if schemes_used is None:
        schemes_used = model_schemes(cfg)
    other = sorted(set(schemes_used) - {"qalora", "intq", "fp"})
    model = (1 if mesh is None else mesh.get("model", 1)
             if isinstance(mesh, dict) else mesh.size("model"))
    if cfg.vocab % model:
        raise NotImplementedError(
            f"{cfg.name}'s vocabulary {cfg.vocab} over model {model}: "
            f"{MESH_NOT_PORTED}")
    if other or "qalora" not in schemes_used:
        raise NotImplementedError(f"linears of scheme(s) {other or ['fp']}: "
                                  f"{MESH_NOT_PORTED}")


def abstract_params(lm: LM):
    """The model's params on the meta device (shapes only)."""
    return lm.init(torch.Generator(), "meta")


def train_state_specs(lm: LM, mesh):
    """(trainable, frozen, optimizer) specs, ``name -> spec`` (the
    optimizer's as ``{"mu", "nu", "step"}``)."""
    trainable, frozen = split_params(abstract_params(lm))
    tspec = param_specs(trainable, mesh)
    fspec = param_specs(frozen, mesh)
    return tspec, fspec, {"mu": tspec, "nu": tspec, "step": ()}


def model_partial_leaves(params) -> Set[str]:
    """The trainable leaves of a shard whose gradient on a rank is a
    partial sum over "model": a ``col`` linear's A and a ``row`` linear's
    B (both replicated, each used by this rank's part of the product)."""
    out = set()
    for name, lp in params.named_modules():
        tp = tp_of(lp) if schemes.is_linear(lp) else None
        if tp is not None and tp.mode is not Mode.WHOLE:
            leaf = "ad.a" if tp.mode is Mode.COL else "ad.b"
            if leaf in dict(lp.named_parameters()):
                out.add(f"{name}.{leaf}")
    return out


def grad_sum_axes(params, dp) -> Dict[str, Tuple[str, ...]]:
    """The axes each trainable leaf's gradient on a rank is summed over:
    the data-parallel axes ``dp`` (those the batch rows split over) its
    expert is not split over (``params.specs.experts``), and "model" for
    :func:`model_partial_leaves`."""
    experts = getattr(params.specs, "experts", {})
    partial = model_partial_leaves(params)
    out = {}
    for name in trainable_tensors(params):
        split = experts.get(name, ((),))[0]
        out[name] = tuple(a for a in dp if a not in split) + (
            ("model",) if name in partial else ())
    return out


def _sum_over(grads: Dict[str, torch.Tensor], names, mesh, axes):
    """``grads[names]`` summed over ``axes`` in one f32 all-reduce, in
    place in the dict (each cast back to its dtype)."""
    names = [k for k in grads if k in names]
    if not names or mesh.size(axes) == 1:
        return
    flat = torch.cat([grads[k].to(torch.float32).reshape(-1) for k in names])
    flat = mesh.all_reduce(flat, axes)
    at = 0
    for k in names:
        g = grads[k]
        grads[k] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
        at += g.numel()


def make_train_step(lm: LM, mesh, opt_cfg: Optional[AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> metrics`` on ``mesh``:
    ``params`` this rank's shard, ``batch`` the global batch (each rank
    takes its rows by :func:`repro_torch.sharding.batch_spec_tree`).  On
    a mesh of one process it is :func:`make_train_fn`.  Metrics as
    there, ``loss`` and ``xent`` over the global batch."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is None or mesh.single:
        return make_train_fn(lm, opt_cfg)

    def train_step(params, opt_state, batch):
        check_mesh_support(lm.cfg, {lp.scheme for lp in params.modules()
                                    if schemes.is_linear(lp)}, mesh)
        trainable = trainable_tensors(params)
        local = shard_tensors(batch, batch_spec_tree(batch, mesh), mesh)
        # the rows split over the data-parallel axes where they divide
        # (batch_spec_tree's rule), else every rank takes them all
        rows = batch["tokens"].shape[0]
        dp = mesh.dp_axes if rows % mesh.size(mesh.dp_axes) == 0 else ()

        def n_reduce(n):
            return mesh.all_reduce(n, dp)
        with moe.rows_over(dp):
            loss, metrics = lm.loss(params, local,
                                    n_reduce=n_reduce if dp else None)
            grads = dict(zip(trainable, torch.autograd.grad(
                loss, list(trainable.values()))))
        by_axes: Dict[Tuple[str, ...], Set[str]] = {}
        for name, axes in grad_sum_axes(params, dp).items():
            by_axes.setdefault(axes, set()).add(name)
        for axes in sorted(by_axes):
            _sum_over(grads, by_axes[axes], mesh, axes)
        om = adamw_update(opt_cfg, grads, opt_state, trainable, mesh,
                          params.specs)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        for k in ("loss", "xent", "aux"):
            out[k] = mesh.all_reduce(out[k], dp)
        return {**out, **om}

    return train_step


def make_decode_step(lm: LM, mesh):
    """The decode step on ``mesh``: returns ``for_cache(cache) -> (step,
    cspec)``, ``cache`` the full decode cache (tensors or ``meta``
    shapes) and ``cspec`` its :func:`~repro_torch.sharding.cache_spec_tree`
    (the reference's ``jit_for`` and its cache shardings; None and
    :meth:`LM.decode_step` itself on one process).
    ``step(params, part, tokens, aux=None) -> (logits, part)`` runs
    :meth:`LM.decode_step` on this rank's shard ``params``, its part of
    the cache (:func:`~repro_torch.sharding.cache_part`, checked leaf by
    leaf against the spec's and advanced in place) and its rows of the
    ``[B, 1]`` tokens (the batch's block over the data-parallel axes
    where the cache's rows split, else all of it); ``logits`` are those
    rows' f32 logits over this rank's block of the vocabulary (its whole
    on a mesh of one "model" process).  The layout it runs on
    (:class:`~repro_torch.sharding.DecodeLayout`) is the spec's."""
    def for_cache(cache):
        if mesh is None or mesh.single:
            return lm.decode_step, None
        cspec = cache_spec_tree(cache, mesh)
        layout = decode_layout(cache, mesh)

        def step(params, part, tokens, aux=None):
            check_cache_part(part, cache, mesh)
            return lm.decode_step(params, part, tokens, aux=aux,
                                  layout=layout)
        return step, cspec
    return for_cache


def _laid_out_as(shard, want) -> bool:
    """Whether every leaf ``shard`` holds is a leaf of the tree whose specs
    are ``want``, split by the same spec (a tree of one process: yes)."""
    specs = getattr(shard, "specs", None)
    if specs is None:
        return True
    own = [n for n, _ in shard.named_buffers()] + \
        [n for n, _ in shard.named_parameters()]
    return all(n in want and want[n] == specs.get(n) for n in own)


def make_generate_step(lm: LM, mesh, gen_len: int, params=None):
    """Greedy generation on ``mesh`` (the reference's ``generate`` under
    its shardings): returns ``for_cache(cache) -> (generate, cspec)`` as
    :func:`make_decode_step` does.  ``generate(shard, part, logits) ->
    (tokens [rows, gen_len] int32, part)`` emits ``gen_len`` tokens from
    the prefill's ``logits`` of this rank's rows (over the whole
    vocabulary or this rank's block of it): token t + 1 is the argmax of
    step t's logits over the whole vocabulary (:func:`tp.greedy`), the
    same on every rank of "model".  mla_moe's absorbed weights are
    computed once a call, on the shard.  ``params`` is the full tree the
    shards come from (the merged one when serving the deployed model, as
    the reference's ``params_abstract``): a shard of another layout is
    refused."""
    want = None if params is None or mesh is None or mesh.single \
        else param_specs(params, mesh)
    decode = make_decode_step(lm, mesh)

    def argmax(logits):
        if logits.shape[-1] == lm.cfg.vocab or mesh is None:
            return logits.argmax(dim=-1).to(torch.int32)
        return tpm.greedy(logits, mesh)

    def for_cache(cache):
        step, cspec = decode(cache)

        @torch.no_grad()
        def generate(shard, part, logits):
            if want is not None and not _laid_out_as(shard, want):
                raise ValueError("the shard is not laid out as the tree "
                                 "the generate step was built for")
            aux = lm.absorbed_weights(shard)
            tok = argmax(logits)
            out = [tok]
            for _ in range(gen_len - 1):
                lg, part = step(shard, part, tok[:, None], aux=aux)
                tok = argmax(lg)
                out.append(tok)
            if gen_len <= 0:
                return torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                                   device=tok.device), part
            return torch.stack(out, dim=1), part
        return generate, cspec
    return for_cache


def make_sync_step(mesh, tspec=None):
    """The periodic cross-pod adapter sync with int8 compression, in place
    on a ``name -> tensor`` dict of adapters
    (:func:`repro_torch.optim.compression.compressed_mean` over "pod");
    None on a mesh without a "pod" axis, as in the reference.  The sync
    averages each leaf with its copies on the other pods: ``tspec`` (a
    shard's specs) must split no expert over "pod" (no ported layout
    does: experts split over "pod" would be averaged with other experts,
    as the reference's ``shard_map`` would average them)."""
    if mesh is None or "pod" not in mesh.shape:
        return None
    over_pod = sorted(k for k, (axes, _, _) in getattr(
        tspec, "experts", {}).items() if "pod" in axes)
    if over_pod:
        raise ValueError(f"the int8 sync over \"pod\" would average "
                         f"different experts: {over_pod[:3]} are split over "
                         f"\"pod\"")

    @torch.no_grad()
    def sync(trainable):
        for k, t in compressed_mean(trainable, mesh, "pod").items():
            trainable[k].copy_(t)
        return trainable

    return sync


__all__ = ["make_train_fn", "make_train_step", "make_sync_step",
           "make_decode_step", "make_generate_step",
           "train_state_specs", "abstract_params", "model_partial_leaves",
           "grad_sum_axes", "check_mesh_support", "model_schemes",
           "adamw_init", "MESH_NOT_PORTED"]
