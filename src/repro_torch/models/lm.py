"""The LMs of every family, gqa, gqa_moe, mla_moe, mamba_hybrid, rwkv and
encdec: init, the training loss, prefill, ragged decode step and greedy
generation.  Counterpart of ``repro.models.lm``: a
gqa_moe block has an ``moe`` FFN (:mod:`repro_torch.models.moe`) where a
gqa block has its ``mlp``; an mla_moe model (DeepSeek-V3) has MLA
attention (:func:`repro_torch.models.attention.mla_apply`),
``n_dense_layers`` dense blocks then MoE blocks with sigmoid routing and a
shared expert, and an MTP head (one extra dense MLA block predicting two
tokens ahead: a loss term in training, a one-token drafter in serving).
A mamba_hybrid model (Zamba2) stacks groups of Mamba2 mixers
(:mod:`repro_torch.models.ssm`, each a residual with no pre-norm), each
group followed by the ONE shared gqa block (its weights held once), then
a tail of Mamba2 mixers; an rwkv model (RWKV6) has blocks of a time mix
and a channel mix, each pre-normed.  Their decode state is recurrent
(:class:`~repro_torch.models.slot_state.SlotState`'s STATE leaves), which a
ragged step advances by each slot's own count, in place.  An encdec model
(Seamless-M4T) has an encoder stack (``enc_blocks``: bidirectional
self-attention and the MLP, then ``enc_ln``) over the audio frontend's
frames, ``batch["src"]`` [B, Ss, d], and a decoder stack (``dec_blocks``:
causal self-attention, cross-attention to the encoder's memory, the MLP);
its decode cache holds the decoder's self K/V and a frozen cross cache,
the cross K/V of each layer, written once (by :meth:`LM.prefill`, or by
the engine at admission from :meth:`LM.encode_cross`) and read by every
step up to the slot's cross ``len``.

Parameters are an :class:`LMParams` module: the embedding, the final norm,
the head (fp, or under an explicit ``lm_head`` policy rule any scheme,
through the same kernels as the blocks' linears) and one block per layer
in a ``ModuleList`` (``blocks``; mla_moe's ``dense_blocks`` and
``moe_blocks``, mamba_hybrid's ``mamba_groups`` (a list of lists),
``mamba_tail`` and ``shared_attn``, encdec's ``enc_blocks``,
``dec_blocks`` and ``enc_ln``, as the reference names its stacks;
the reference stacks layers on a leading axis and scans, here a Python
loop walks the list).  Every projection routes through the
linear-scheme API, so a ``qalora`` model, its merged ``intq`` model and
the kernel routing are policy switches.

Batch format: ``{"tokens": [B, S] int}``, plus ``"labels"`` ([B, S] int,
-1 = not supervised) for :meth:`LM.loss`, and for a config with
``frontend="vision"`` (pixtral-12b's stub) optionally ``"frontend"`` ([B,
F, d_model] patch embeddings), prepended to the token embeddings by
:meth:`LM._inputs_to_x` for the loss (its F positions carry no label) and
the prefill (the cache holds F + S rows).  :meth:`LM.loss` runs with
autograd on and recomputes each block in the backward when ``cfg.remat``
(an MoE block's routing is recorded once, in the forward); prefill and
decode run under ``torch.no_grad``.  Decode caches follow
:class:`repro_torch.models.slot_state.SlotState`; decode steps write their
cache rows and lengths into the cache they are given, in place, and
return it.  An mla_moe decode step attends in the compressed space
through each layer's absorbed ``kv_up`` halves (:meth:`LM.absorbed_weights`),
which a serving loop computes once and passes to every step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schemes
from repro_torch.runtime.graphs import StepGraphs
from .attention import (StepPlan, cross_apply, cross_chunk, cross_init,
                        cross_kv, gqa_apply, gqa_init, gqa_prefill_chunk,
                        kv_up_split, mla_apply, mla_init, mla_prefill_chunk)
from .common import rmsnorm, rmsnorm_init
from . import tp
from .mlp import mlp_apply, mlp_init
from .moe import moe_apply, moe_init, rows_over, suspend_recording
from .slot_state import (SlotState, attn_cfg as _attn_cfg, cache_leaves,
                         check_family, hybrid_layout, mamba_cfg as _mamba_cfg,
                         mla_cfg as _mla_cfg, rwkv_cfg as _rwkv_cfg)
from .ssm import (mamba2_chunk_step, mamba2_init, mamba2_mix,
                  rwkv6_channel_mix, rwkv6_channel_mix_ragged, rwkv6_init,
                  rwkv6_time_mix, rwkv6_time_mix_ragged)


class LMParams(nn.Module):
    """Model parameters: buffer ``embed [V, d]``, ``final_ln``, ``head``
    (a tagged linear ``[d, V]``, None when tied) and ``blocks``.  An
    mla_moe model gives ``parts``: ``dense_blocks`` and ``moe_blocks``
    (lists of blocks; ``blocks`` is then empty) and, with an MTP head,
    ``mtp_proj`` (an exempt fp linear ``[2d, d]``), ``mtp_block`` and
    ``mtp_ln``; a mamba_hybrid model ``mamba_groups`` (a list of lists of
    Mamba2 mixers), ``mamba_tail`` and ``shared_attn`` (one gqa block); an
    encdec model ``enc_blocks``, ``dec_blocks`` and ``enc_ln``."""

    def __init__(self, embed: torch.Tensor, final_ln: nn.Module,
                 head: Optional[schemes.LinearParams], blocks: List[nn.Module],
                 parts: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.register_buffer("embed", embed)
        self.final_ln = final_ln
        self.head = head
        self.blocks = nn.ModuleList(blocks)
        for name, part in (parts or {}).items():
            if isinstance(part, list):
                part = nn.ModuleList(nn.ModuleList(p) if isinstance(p, list)
                                     else p for p in part)
            setattr(self, name, part)

    def layer_blocks(self) -> List[nn.Module]:
        """Every layer's block in order (mla_moe: the dense ones first)."""
        if hasattr(self, "dense_blocks"):
            return [*self.dense_blocks, *self.moe_blocks]
        return list(self.blocks)


def _gqa_block_init(generator, cfg: ArchConfig, pol, device) -> nn.ModuleDict:
    p = nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(generator, _attn_cfg(cfg), pol.at("attn"), device),
    })
    if cfg.family == "gqa_moe":
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                            cfg.n_experts, pol.at("moe"),
                            n_shared=cfg.n_shared_experts,
                            shared_d_ff=cfg.moe_d_ff or cfg.d_ff,
                            routing=cfg.routing, device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, pol.at("mlp"),
                            cfg.gated_mlp, device)
    return p


def _rwkv_block_init(generator, cfg: ArchConfig, pol, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "mix": rwkv6_init(generator, _rwkv_cfg(cfg), pol.at("mix"), device)})


def _rwkv_block(p, x, cfg: ArchConfig):
    """One RWKV6 block over whole sequences -> (x, its decode state)."""
    rcfg = _rwkv_cfg(cfg)
    y, (tp, wkv) = rwkv6_time_mix(p["mix"], rmsnorm(p["ln1"], x), rcfg)
    x = x + y
    y, cp = rwkv6_channel_mix(p["mix"], rmsnorm(p["ln2"], x), rcfg)
    return x + y, {"tm_prev": tp, "wkv": wkv, "cm_prev": cp}


def _rwkv_block_train(p, x, cfg: ArchConfig):
    return _rwkv_block(p, x, cfg)[0], None


def _mamba_block(p, x, cfg: ArchConfig):
    """One Mamba2 layer over whole sequences (a residual, no pre-norm) ->
    (x, its decode state)."""
    y, st = mamba2_mix(p, x, _mamba_cfg(cfg), return_state=True)
    return x + y, st


def _mamba_block_train(p, x, cfg: ArchConfig):
    return x + mamba2_mix(p, x, _mamba_cfg(cfg)), None


def _enc_block_init(generator, cfg: ArchConfig, pol, device) \
        -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(generator, _attn_cfg(cfg), pol.at("attn"), device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, pol.at("mlp"),
                        cfg.gated_mlp, device)})


def _dec_block_init(generator, cfg: ArchConfig, pol, device) \
        -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "ln3": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(generator, _attn_cfg(cfg), pol.at("attn"), device),
        "cross": cross_init(generator, _attn_cfg(cfg), pol.at("cross"),
                            device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, pol.at("mlp"),
                        cfg.gated_mlp, device)})


def _enc_block(p, x, cfg: ArchConfig, src_len=None):
    """One encoder block: bidirectional self-attention (keys at or past
    ``src_len[b]`` masked, when given) and the MLP, each pre-normed (the
    reference's norms here take rmsnorm's default eps)."""
    a, _ = gqa_apply(p["attn"], rmsnorm(p["ln1"], x), _attn_cfg(cfg),
                     causal=False, kv_len=src_len, chunk_q=cfg.chunk_q,
                     chunk_k=cfg.chunk_k)
    x = x + a
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.act)


def _dec_block(p, x, memory, cfg: ArchConfig):
    """One decoder block over whole sequences: causal self-attention,
    cross-attention to ``memory`` [B, Ss, d], the MLP.  Returns (x, (k,
    v), (cross k, cross v))."""
    acfg = _attn_cfg(cfg)
    a, kv = gqa_apply(p["attn"], rmsnorm(p["ln1"], x), acfg,
                      chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    x = x + a
    km, vm = cross_kv(p["cross"], memory, acfg)
    x = x + cross_apply(p["cross"], rmsnorm(p["ln2"], x), km, vm, acfg,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    x = x + mlp_apply(p["mlp"], rmsnorm(p["ln3"], x), cfg.act)
    return x, kv, (km, vm)


def _dec_block_train(p, x, memory, cfg: ArchConfig):
    return _dec_block(p, x, memory, cfg)[0]


def _mla_block_init(generator, cfg: ArchConfig, pol, moe: bool,
                    device) -> nn.ModuleDict:
    """An MLA block: the routed experts with ``moe``, each of d_ff
    ``moe_d_ff``, and a shared expert of that width (the reference's
    ``shared_d_ff=cfg.moe_d_ff``), or the dense MLP."""
    p = nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "attn": mla_init(generator, _mla_cfg(cfg), pol.at("attn"), device),
    })
    if moe:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe_d_ff,
                            cfg.n_experts, pol.at("moe"),
                            n_shared=cfg.n_shared_experts,
                            shared_d_ff=cfg.moe_d_ff, routing=cfg.routing,
                            device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, pol.at("mlp"),
                            cfg.gated_mlp, device)
    return p


def _ffn(p, h, cfg: ArchConfig, moe_chunk: int):
    """The block's FFN on h -> (y, aux): the MoE routed ``moe_chunk``
    positions at a time (0: all at once) with its load-balance aux loss,
    or the MLP and None."""
    if "moe" in p:
        return moe_apply(p["moe"], h, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         routing=cfg.routing, act=cfg.act,
                         moe_chunk=moe_chunk)
    return mlp_apply(p["mlp"], h, cfg.act), None


def _gqa_block(p, x, cfg: ArchConfig, *, window=None, theta=None):
    """One block -> (x, (k, v), aux or None)."""
    a, kv = gqa_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                      _attn_cfg(cfg), window=window, theta=theta,
                      chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    x = x + a
    m, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, cfg.moe_chunk)
    return x + m, kv, aux


def _mla_block(p, x, cfg: ArchConfig):
    """One MLA block over whole sequences -> (x, (c, k_rope), aux or
    None)."""
    a, ckv = mla_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                       _mla_cfg(cfg))
    x = x + a
    m, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, cfg.moe_chunk)
    return x + m, ckv, aux


def _mla_block_train(p, x, cfg: ArchConfig):
    y, _, aux = _mla_block(p, x, cfg)
    return y, aux


def _mla_block_chunk(p, x, cache, cur_len, n_new, cfg: ArchConfig, *,
                     w_kv=None, plan=None):
    """Ragged chunk through one MLA block (``w_kv``: the layer's absorbed
    weights, derived per step when None)."""
    a, cache = mla_prefill_chunk(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cache, cur_len, n_new, _mla_cfg(cfg),
                                 w_kv=w_kv, plan=plan)
    x = x + a
    m, _ = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, 0)
    return x + m, cache


def _recompute_contexts():
    """checkpoint's ``context_fn``: nothing around the forward, and no
    routing recorded in the backward's recompute."""
    return contextlib.nullcontext(), suspend_recording()


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint`` in the reference) when ``cfg.remat``."""
    if not cfg.remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_recompute_contexts)


def _gqa_block_train(p, x, cfg: ArchConfig, window, theta):
    """One block in training -> (x, aux or None)."""
    y, _, aux = _gqa_block(p, x, cfg, window=window, theta=theta)
    return y, aux


def _gqa_block_chunk(p, x, cache, cur_len, n_new, cfg: ArchConfig, *,
                     window=None, theta=None, plan=None):
    """Ragged chunk through one block: x [B,C,d], per-slot n_new consumed."""
    a, cache = gqa_prefill_chunk(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cache, cur_len, n_new, _attn_cfg(cfg),
                                 window=window, theta=theta, plan=plan)
    x = x + a
    # a ragged, decode, burst or verify step routes all its B x C rows at
    # once, padding rows included, as the reference does
    m, _ = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, 0)
    return x + m, cache


def _stack_layers(ts, x, dim: int):
    """Per-layer cache rows [B, S, dim] stacked on a leading layer axis (an
    empty stack ``[0, B, S, dim]``, as a config without dense layers has)."""
    if ts:
        return torch.stack(ts)
    return x.new_zeros((0,) + tuple(x.shape[:2]) + (dim,))


def _stack_states(sts):
    """Per-layer state dicts stacked on a leading layer axis, key by key."""
    return {k: torch.stack([st[k] for st in sts]) for k in sts[0]}


def _empty_states(slot_state, x):
    """A zero-layer Mamba2 state stack (a hybrid without tail layers), as
    the reference's scan over an empty stack gives."""
    spec = slot_state.layout(x.shape[0], 1)["layers"]["tail"]
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=x.device)
            for k, s in spec.items()}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    there is none (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    return dev


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig

    def __post_init__(self):
        check_family(self.cfg)
        cfg = self.cfg
        if cfg.family == "mla_moe" and not 0 <= cfg.n_dense_layers \
                <= cfg.n_layers:
            raise ValueError(f"n_dense_layers {cfg.n_dense_layers} is not "
                             f"within the {cfg.n_layers} layers")

    def layer_linears(self, layer: int = 0) -> int:
        """Quantized linears of block ``layer`` under a policy that
        quantizes every block linear: attention's 4 (MLA's 5: q_down, q_up,
        kv_down, kv_up, wo), then the gated MLP's 3 (2 when not gated), or
        each expert's gate, up and down plus the shared experts' MLP (the
        router stays fp); RWKV6's 8 (wr wk wv wg wo ck cv cr: the decay
        LoRA stays fp); a Mamba2 layer's 2 (in_proj, out_proj); an encdec
        decoder layer's 8 in a decode or ragged step (self-attention's 4,
        cross-attention's wq and wo, the MLP's 2: the cross wk and wv run
        once, at admission).  mla_moe's blocks differ by layer (its first
        ``n_dense_layers`` have the MLP) and so do mamba_hybrid's: the last
        layer of each group of ``attn_every`` is an application of the
        shared gqa block."""
        cfg = self.cfg
        mlp = 3 if cfg.gated_mlp else 2
        if cfg.family == "encdec":
            return 6 + mlp
        experts = 3 * cfg.n_experts + (3 if cfg.n_shared_experts else 0)
        if cfg.family == "mla_moe":
            return 5 + (mlp if layer < cfg.n_dense_layers else experts)
        if cfg.family == "gqa_moe":
            return 4 + experts
        if cfg.family == "rwkv":
            return 8
        if cfg.family == "mamba_hybrid":
            ng = hybrid_layout(cfg)[0]
            shared = (layer < ng * cfg.attn_every
                      and layer % cfg.attn_every == cfg.attn_every - 1)
            return 4 + mlp if shared else 2
        return 4 + mlp

    def step_linears(self) -> int:
        """Quantized linears of one pass through the layer stack (the MTP
        head runs only in the loss and the MTP drafter; the shared block
        of mamba_hybrid counts once an application)."""
        return sum(self.layer_linears(i) for i in range(self.cfg.n_layers))

    def encode_linears(self) -> int:
        """Quantized linears of :meth:`encode_cross` (encdec): each encoder
        block's 4 + MLP and each decoder layer's cross wk and wv; 0 for the
        other families."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return 0
        mlp = 3 if cfg.gated_mlp else 2
        return cfg.n_enc_layers * (4 + mlp) + 2 * cfg.n_layers

    def pass_linears(self) -> int:
        """Quantized linears of one pass over whole sequences (the loss's
        forward, a prefill): :meth:`step_linears`, and for encdec the
        encoder and the cross wk and wv too."""
        return self.step_linears() + self.encode_linears()

    # ---------------- init ----------------

    def init(self, generator: torch.Generator, device="cuda") -> LMParams:
        """Random init on ``device``, one layer at a time: each quantized
        linear is drawn in f32 and quantized at once, so peak memory stays
        near the quantized model's size."""
        cfg, pol = self.cfg, self.cfg.quant
        dev = resolve_device(device)
        d = cfg.d_model

        def randn(shape):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32)

        embed = (randn((cfg.vocab, d)) * 0.02).to(pol.dtype)
        head = None
        if not cfg.tie_embeddings:
            # the head stays fp unless a policy rule names lm_head
            w = (randn((d, cfg.vocab)) * 0.02).to(pol.dtype)
            hpol = schemes.resolve_path(pol, "lm_head")
            head = (schemes.dense_linear(w, hpol) if hpol.mode == "fp"
                    else schemes.from_dense_linear(generator, w, hpol))
            del w
        if cfg.family == "mla_moe":
            return LMParams(embed, rmsnorm_init(d, device=dev), head, [],
                            parts=self._mla_init(generator, dev))
        if cfg.family == "mamba_hybrid":
            return LMParams(embed, rmsnorm_init(d, device=dev), head, [],
                            parts=self._hybrid_init(generator, dev))
        if cfg.family == "encdec":
            epol, dpol = pol.at("enc_blocks"), pol.at("dec_blocks")
            parts = {"enc_blocks": [_enc_block_init(generator, cfg, epol, dev)
                                    for _ in range(cfg.n_enc_layers)],
                     "dec_blocks": [_dec_block_init(generator, cfg, dpol, dev)
                                    for _ in range(cfg.n_layers)],
                     "enc_ln": rmsnorm_init(d, device=dev)}
            return LMParams(embed, rmsnorm_init(d, device=dev), head, [],
                            parts=parts)
        bpol = pol.at("blocks")
        init = (_rwkv_block_init if cfg.family == "rwkv"
                else _gqa_block_init)
        blocks = [init(generator, cfg, bpol, dev)
                  for _ in range(cfg.n_layers)]
        return LMParams(embed, rmsnorm_init(d, device=dev), head, blocks)

    def _hybrid_init(self, generator, dev) -> Dict[str, Any]:
        """mamba_hybrid's parts: the groups' and the tail's Mamba2 mixers
        and the one shared gqa block."""
        cfg, pol = self.cfg, self.cfg.quant
        ng, per, tail = hybrid_layout(cfg)
        mcfg = _mamba_cfg(cfg)
        gpol, tpol = pol.at("mamba_groups"), pol.at("mamba_tail")
        return {"mamba_groups": [[mamba2_init(generator, mcfg, gpol, dev)
                                  for _ in range(per)] for _ in range(ng)],
                "mamba_tail": [mamba2_init(generator, mcfg, tpol, dev)
                               for _ in range(tail)],
                "shared_attn": _gqa_block_init(generator, cfg,
                                               pol.at("shared_attn"), dev)}

    def _mla_init(self, generator, dev) -> Dict[str, Any]:
        """mla_moe's parts: the dense and MoE stacks, and with ``cfg.mtp``
        the MTP head, whose ``mtp_proj`` is an exempt fp linear (never
        quantized or converted, as in the reference)."""
        cfg, pol = self.cfg, self.cfg.quant
        nd, d = cfg.n_dense_layers, cfg.d_model
        dpol, mpol = pol.at("dense_blocks"), pol.at("moe_blocks")
        out: Dict[str, Any] = {
            "dense_blocks": [_mla_block_init(generator, cfg, dpol, False, dev)
                             for _ in range(nd)],
            "moe_blocks": [_mla_block_init(generator, cfg, mpol, True, dev)
                           for _ in range(cfg.n_layers - nd)]}
        if cfg.mtp:
            out["mtp_proj"] = schemes.linear_init(
                generator, 2 * d, d, pol.at("mtp_proj"), dev, exempt=True)
            out["mtp_block"] = _mla_block_init(generator, cfg,
                                               pol.at("mtp_block"), False,
                                               dev)
            out["mtp_ln"] = rmsnorm_init(d, device=dev)
        return out

    # ---------------- shared pieces ----------------

    def _layer_extras(self):
        """Per-layer (window, rope_theta) (gemma3's local:global
        interleave); window 0 means full attention."""
        cfg = self.cfg
        out = []
        for layer in range(cfg.n_layers):
            if cfg.global_every and (layer % cfg.global_every
                                     == cfg.global_every - 1):
                out.append((0, cfg.global_rope_theta))
            else:
                out.append((cfg.window or 0, cfg.rope_theta))
        return out

    def _embed(self, params: LMParams, tokens):
        mesh = tp.model_mesh(params)
        if mesh is not None:  # a shard: the vocabulary split over "model"
            return tp.embed(params.embed, tokens, mesh)
        return params.embed[tokens.to(torch.int64)]

    def _patches(self, batch):
        """The vision stub's patch embeddings [B, F, d] of ``batch``, or
        None (no frontend, or none given: text-only prompts)."""
        if self.cfg.frontend == "vision":
            return batch.get("frontend")
        return None

    def _inputs_to_x(self, params: LMParams, batch):
        """Token embeds, with the patch embeds (cast to their dtype)
        prepended: the one place a batch becomes the trunk's input."""
        x = self._embed(params, batch["tokens"])
        f = self._patches(batch)
        if f is not None:
            x = torch.cat([f.to(x.dtype), x], dim=1)
        return x

    def _logits(self, params: LMParams, h):
        """Logits f32 (on a shard, this rank's vocabulary columns)."""
        mesh = tp.model_mesh(params)
        if mesh is not None:
            return tp.logits(params.head, h, mesh)
        if self.cfg.tie_embeddings:
            return (h @ params.embed.T.to(h.dtype)).to(torch.float32)
        return schemes.linear_apply(params.head, h).to(torch.float32)

    def _xent(self, params: LMParams, h, labels, n_reduce=None):
        """Chunked softmax cross-entropy over ``cfg.xent_chunk`` positions
        at a time (never ``[B, S, V]`` logits at once): labels < 0 are
        masked, and the mean is ``loss_sum / max(n, 1)``.  Each chunk's
        logits come from :meth:`_logits`, so a quantized head runs its
        scheme's kernel (the reference multiplies by the head's dense
        view: the same product, another order of sums).  On a shard the
        chunk is vocabulary-parallel
        (:func:`repro_torch.models.tp.xent_sums`).  ``n_reduce`` maps the
        count n to the global batch's before the division (a sum over the
        data-parallel axes)."""
        s = h.shape[1]
        c = min(self.cfg.xent_chunk, s)
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of xent_chunk "
                             f"{c}")
        mesh = tp.model_mesh(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        n = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s, c):
            if mesh is not None:
                part, count = tp.xent_sums(params.head, h[:, i:i + c],
                                           labels[:, i:i + c], mesh)
                loss_sum, n = loss_sum + part, n + count
                continue
            logits = self._logits(params, h[:, i:i + c])
            yc = labels[:, i:i + c].to(torch.int64)
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, yc.clamp(min=0)[..., None])[..., 0]
            mask = (yc >= 0).to(torch.float32)
            loss_sum = loss_sum + ((lse - ll) * mask).sum()
            n = n + mask.sum()
        if n_reduce is not None:
            n = n_reduce(n)
        return loss_sum / n.clamp(min=1.0)

    def _trunk(self, params: LMParams, x, collect_cache: bool = False):
        """Runs the layer stack.  Returns (h, cache or None)."""
        if self.cfg.family == "mla_moe":
            return self._mla_trunk(params, x, collect_cache)
        if self.cfg.family == "mamba_hybrid":
            return self._hybrid_trunk(params, x, collect_cache)
        if self.cfg.family == "rwkv":
            sts = []
            for blk in params.blocks:
                x, st = _rwkv_block(blk, x, self.cfg)
                sts.append(st)
            return x, _stack_states(sts) if collect_cache else None
        ks, vs = [], []
        for blk, (window, theta) in zip(params.blocks, self._layer_extras()):
            x, (k, v), _ = _gqa_block(blk, x, self.cfg, window=window,
                                      theta=theta)
            if collect_cache:
                ks.append(k)
                vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
            if collect_cache else None
        return x, cache

    def _hybrid_trunk(self, params: LMParams, x, collect_cache: bool):
        """mamba_hybrid's stack: each group's Mamba2 layers then the shared
        block, then the tail; the cache holds every Mamba2 layer's state
        and the shared block's K/V of each group."""
        cfg = self.cfg
        groups, ks, vs = [], [], []
        for gblk in params.mamba_groups:
            sts = []
            for blk in gblk:
                x, st = _mamba_block(blk, x, cfg)
                sts.append(st)
            groups.append(_stack_states(sts))
            x, (k, v), _ = _gqa_block(params.shared_attn, x, cfg)
            ks.append(k)
            vs.append(v)
        tail = []
        for blk in params.mamba_tail:
            x, st = _mamba_block(blk, x, cfg)
            tail.append(st)
        if not collect_cache:
            return x, None
        return x, {"groups": _stack_states(groups),
                   "tail": _stack_states(tail) if tail else _empty_states(
                       self.slot_state(), x), "k": torch.stack(ks),
                   "v": torch.stack(vs)}

    def _mla_trunk(self, params: LMParams, x, collect_cache: bool):
        """mla_moe's stack: the compressed cache of the dense and the MoE
        layers."""
        cache = {}
        for part in ("dense", "moe"):
            cs, krs = [], []
            for blk in getattr(params, f"{part}_blocks"):
                x, (c, kr), _ = _mla_block(blk, x, self.cfg)
                cs.append(c)
                krs.append(kr)
            if collect_cache:
                cache[part] = {"c": _stack_layers(cs, x, self.cfg.kv_lora_rank),
                               "kr": _stack_layers(krs, x,
                                                   self.cfg.qk_rope_dim)}
        return x, cache if collect_cache else None

    # ---------------- encoder (enc-dec) ----------------

    def _encode(self, params: LMParams, src, src_len=None):
        """The encoder over ``src`` [B, Ss, d] (cast to the embedding's
        dtype) -> the memory [B, Ss, d], after ``enc_ln``.  ``src_len``
        ([B] int tensor, optional) masks the keys at or past each row's
        valid frames, so a zero-padded (bucketed) source gives its valid
        rows as the unpadded source does, up to rounding; padded rows are
        garbage but finite, and callers drop them.  Each block is
        recomputed in the backward when ``cfg.remat`` and autograd is
        on."""
        x = src.to(params.embed.dtype)
        enc = functools.partial(_enc_block, cfg=self.cfg, src_len=src_len)
        if torch.is_grad_enabled():
            enc = _maybe_remat(enc, self.cfg)
        for blk in params.enc_blocks:
            x = enc(blk, x)
        return rmsnorm(params.enc_ln, x)

    def _decode_trunk(self, params: LMParams, x, memory):
        """The decoder stack over whole sequences with the cross caches
        taken from ``memory`` -> (x, the self K/V stacked on a layer axis,
        the cross K/V likewise)."""
        ks, vs, cks, cvs = [], [], [], []
        for blk in params.dec_blocks:
            x, (k, v), (ck, cv) = _dec_block(blk, x, memory, self.cfg)
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
        return x, ({"k": torch.stack(ks), "v": torch.stack(vs)},
                   {"k": torch.stack(cks), "v": torch.stack(cvs)})

    @torch.no_grad()
    def encode_cross(self, params: LMParams, src, src_len=None):
        """The encoder over ``src`` [B, Ss, d] and every decoder layer's
        cross K/V of its memory: (k, v), each [L, B, Ss, KvH, hd].  The
        continuous engine runs it once a request, at admission, and pins
        the result into the slot's frozen cross cache.  ``src_len`` as in
        :meth:`_encode`: rows at or past it are garbage, and are not
        pinned."""
        memory = self._encode(params, src, src_len)
        acfg = _attn_cfg(self.cfg)
        kv = [cross_kv(blk["cross"], memory, acfg)
              for blk in params.dec_blocks]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    # ---------------- public API ----------------

    def loss(self, params: LMParams, batch: Dict[str, Any], n_reduce=None):
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, [B, S]), plus 0.3 times the MTP head's (mla_moe with
        its head: :meth:`_mtp_loss`), plus ``cfg.aux_coef`` times the
        MoE's load-balance loss summed over the layers (0 for gqa; on a
        shard each rank adds its share of the global batch's), with
        autograd on.  Returns (loss, {"xent", "aux"}), xent before the MTP
        and aux terms, as the reference does.  Patch positions carry no
        label.  An encdec batch also gives ``src`` [B, Ss, d], the
        encoder's frames.  ``n_reduce`` as in :meth:`_xent` (the sharded
        train step's data-parallel count)."""
        if self.cfg.family == "encdec":
            memory = self._encode(params, batch["src"])
            x = self._embed(params, batch["tokens"])
            block = _maybe_remat(functools.partial(_dec_block_train,
                                                   cfg=self.cfg), self.cfg)
            for blk in params.dec_blocks:
                x = block(blk, x, memory)
            h = rmsnorm(params.final_ln, x, self.cfg.norm_eps)
            xent = self._xent(params, h, batch["labels"], n_reduce)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return xent, {"xent": xent, "aux": aux}
        x = self._inputs_to_x(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.family == "mla_moe":
            blocks = [(blk, functools.partial(_mla_block_train, cfg=self.cfg))
                      for blk in params.layer_blocks()]
        elif self.cfg.family == "rwkv":
            blocks = [(blk, functools.partial(_rwkv_block_train, cfg=self.cfg))
                      for blk in params.blocks]
        elif self.cfg.family == "mamba_hybrid":
            mamba = functools.partial(_mamba_block_train, cfg=self.cfg)
            shared = (params.shared_attn, functools.partial(
                _gqa_block_train, cfg=self.cfg, window=None, theta=None))
            blocks = [b for gblk in params.mamba_groups
                      for b in [(blk, mamba) for blk in gblk] + [shared]]
            blocks += [(blk, mamba) for blk in params.mamba_tail]
        else:
            blocks = [(blk, functools.partial(_gqa_block_train, cfg=self.cfg,
                                              window=window, theta=theta))
                      for blk, (window, theta) in zip(params.blocks,
                                                      self._layer_extras())]
        for blk, block in blocks:
            x, a = _maybe_remat(block, self.cfg)(blk, x)
            if a is not None:
                aux = aux + a
        h = rmsnorm(params.final_ln, x, self.cfg.norm_eps)
        labels = batch["labels"]
        f = self._patches(batch)
        if f is not None:
            labels = torch.cat([labels.new_full((labels.shape[0],
                                                 f.shape[1]), -1), labels],
                               dim=1)
        xent = self._xent(params, h, labels, n_reduce)
        loss = xent
        if self._has_mtp(params):
            loss = loss + 0.3 * self._mtp_loss(params, h, batch, labels,
                                               n_reduce)
        return loss + self.cfg.aux_coef * aux, {"xent": xent, "aux": aux}

    def _has_mtp(self, params: LMParams) -> bool:
        return (self.cfg.family == "mla_moe" and self.cfg.mtp
                and hasattr(params, "mtp_block"))

    def _mtp_head(self, params: LMParams, h, next_emb):
        """The MTP block on the final-normed states ``h`` [B, C, d] and the
        next tokens' embeddings: mtp_ln(h) beside them -> ``mtp_proj`` ->
        one dense MLA block (its own positions 0..C-1, as the reference's).
        Returns its output [B, C, d], not normed (the reference feeds it to
        the head as it is)."""
        cat = torch.cat([rmsnorm(params.mtp_ln, h), next_emb.to(h.dtype)],
                        dim=-1)
        shard = tp.tp_of(params.mtp_proj)
        x = (schemes.linear_apply(params.mtp_proj, cat) if shard is None
             else tp.full_output(params.mtp_proj, cat, shard.mesh))
        return _mla_block(params.mtp_block, x, self.cfg)[0]

    def _mtp_loss(self, params: LMParams, h, batch, labels, n_reduce=None):
        """DeepSeek-V3's multi-token prediction: one extra depth predicting
        token t+2 from position t (the last position unsupervised);
        ``n_reduce`` as in :meth:`_xent`."""
        emb_next = torch.roll(self._inputs_to_x(params, batch), -1, dims=1)
        x = self._mtp_head(params, h, emb_next)
        labels2 = torch.roll(labels, -1, dims=1)
        labels2[:, -1] = -1
        return self._xent(params, x, labels2, n_reduce)

    def mtp_draft_logits(self, params: LMParams, h, next_tokens):
        """The MTP head as a drafter: from :meth:`verify_ragged`'s hidden
        states ``h`` [B, C, d] and the next token at each position (the
        verify argmax), ``logits[b, i]`` [B, C, V] f32 drafts the token
        after that one, as :meth:`_mtp_loss` predicts it in training."""
        return self._logits(params, self._mtp_head(
            params, h, self._embed(params, next_tokens)))

    def _prefill(self, params: LMParams, batch: Dict[str, Any]):
        """The final-normed hidden states of every position (patches
        first), and the prefill cache, whose length counts the patch
        rows.  An encdec batch's ``src`` goes through the encoder, and the
        cache's cross ``len`` is its frame count."""
        if self.cfg.family == "encdec":
            memory = self._encode(params, batch["src"])
            x = self._embed(params, batch["tokens"])
            h, (selfc, crossc) = self._decode_trunk(params, x, memory)
            crossc["len"] = torch.full((x.shape[0],), memory.shape[1],
                                       dtype=torch.int32, device=x.device)
            cache = {"self": selfc, "cross": crossc}
        else:
            x = self._inputs_to_x(params, batch)
            h, cache = self._trunk(params, x, collect_cache=True)
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
        return (rmsnorm(params.final_ln, h, self.cfg.norm_eps),
                {"layers": cache, "len": length})

    @torch.no_grad()
    def prefill(self, params: LMParams, batch: Dict[str, Any]):
        """Returns (last-token logits [B, V] f32, cache dict)."""
        h, cache = self._prefill(params, batch)
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def prefill_all(self, params: LMParams, batch: Dict[str, Any]):
        """:meth:`prefill` with the logits of every position, [B, F + S,
        V] f32 (the MoE merge check compares token by token)."""
        h, cache = self._prefill(params, batch)
        return self._logits(params, h), cache

    def slot_state(self, page_size: int = 0, n_pages: int = 0) -> SlotState:
        """The decode-cache layout and lifecycle; ``page_size > 0`` selects
        the paged pools (``n_pages`` pages, the null page included)."""
        return SlotState(self.cfg, page_size=page_size, n_pages=n_pages)

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device="cuda", src_cap: Optional[int] = None):
        """Fresh decode cache (see :class:`SlotState`; for encdec ``seq``
        is split into source and decoder capacities unless ``src_cap``
        is given)."""
        return self.slot_state().init(batch, seq, dtype=dtype,
                                      device=resolve_device(device),
                                      src_cap=src_cap)

    def decode_step(self, params: LMParams, cache, tokens, aux=None,
                    layout=None):
        """tokens: [B, 1] -> (logits [B, V], updated cache): the C=1
        always-active case of :meth:`step_ragged`."""
        return self.step_ragged(params, cache, tokens,
                                torch.ones_like(cache["len"]), aux=aux,
                                layout=layout)

    @torch.no_grad()
    def absorbed_weights(self, params: LMParams):
        """The step-invariant part of mla_moe's absorbed decode: every
        layer's effective (adapter-included) ``kv_up`` dequantised in the
        config's dtype and split into (W_uk, W_uv), ``{"dense": [(W_uk,
        W_uv), ...], "moe": [...]}``; None for the other families.  A
        serving loop computes it once and passes it to every step as
        ``aux``, so no step dequantises ``kv_up``."""
        if self.cfg.family != "mla_moe":
            return None
        mcfg, dt = _mla_cfg(self.cfg), self.cfg.quant.dtype
        return {part: [kv_up_split(blk["attn"], mcfg, dt)
                       for blk in getattr(params, f"{part}_blocks")]
                for part in ("dense", "moe")}

    @torch.no_grad()
    def step_ragged(self, params: LMParams, cache, tokens, n_new, aux=None,
                    layout=None):
        """Ragged serve step: slot b consumes ``tokens[b, :n_new[b]]`` at
        positions ``len[b]..`` and advances by ``n_new[b]``, writing the
        cache in place.  ``aux`` is :meth:`absorbed_weights` of ``params``
        (mla_moe; derived inside the step when None).  Returns (logits
        [B, V] at each slot's last consumed row, cache).

        On a mesh (``params`` a shard) ``cache`` and ``tokens`` are this
        rank's part and rows, ``layout`` the cache's
        :class:`~repro_torch.sharding.shard.DecodeLayout` (the MoE layers
        route the rows over its ``rows`` axes), and the logits this rank's
        block of the vocabulary (:func:`repro_torch.launch.steps.
        make_decode_step`)."""
        if hasattr(params, "specs") and layout is None:
            raise ValueError("a shard's ragged step needs its cache's "
                             "DecodeLayout (repro_torch.launch.steps."
                             "make_decode_step)")
        rows = rows_over(layout.rows) if layout is not None \
            else contextlib.nullcontext()
        with rows:
            h, n_new = self._ragged_trunk(params, cache, tokens, n_new, aux,
                                          layout)
        last = (n_new.to(torch.int64) - 1).clamp(0, tokens.shape[1] - 1)
        idx = last[:, None, None].expand(h.shape[0], 1, h.shape[2])
        h_last = torch.gather(h, 1, idx)
        logits = self._logits(params, h_last)[:, 0]
        return logits, self.slot_state().advance(cache, n_new)

    @torch.no_grad()
    def verify_ragged(self, params: LMParams, cache, tokens, n_new,
                      aux=None):
        """The ragged step of draft-and-verify speculation: as
        :meth:`step_ragged`, but with logits at EVERY row, ``logits[b, i]``
        predicting the token after ``tokens[b, i]``, and the final-normed
        hidden states (the MTP drafter's input); rows ``i >= n_new[b]``
        are garbage (callers mask).  Returns (logits [B, C, V], h [B, C,
        d], cache).  The cache advances by the full ``n_new``; a caller
        that rejects a draft suffix rolls it back by shrinking ``len``
        (sound since ``SlotState.supports_rollback()``)."""
        h, n_new = self._ragged_trunk(params, cache, tokens, n_new, aux)
        logits = self._logits(params, h)
        return logits, h, self.slot_state().advance(cache, n_new)

    def _ragged_trunk(self, params: LMParams, cache, tokens, n_new,
                      aux=None, layout=None):
        """The layer stack of a ragged step, on a contiguous or paged cache
        (a paged cache's capacity is its page rows' width), or a rank's
        part of one under ``layout``."""
        cur = cache["len"]
        n_new = n_new.to(torch.int32)
        x = self._embed(params, tokens)
        pages = cache.get("pages")
        if self.cfg.family == "rwkv":
            return self._rwkv_ragged(params, cache, x, n_new), n_new
        if self.cfg.family == "mamba_hybrid":
            return self._hybrid_ragged(params, cache, x, n_new), n_new
        if self.cfg.family == "encdec":
            return self._encdec_ragged(params, cache, x, n_new), n_new
        if self.cfg.family == "mla_moe":
            lay = cache["layers"]
            leaf = cache_leaves(lay)[0]
            s = leaf.shape[2] if pages is None \
                else pages.shape[1] * leaf.shape[2]
            plan = StepPlan(cur, n_new, tokens.shape[1], s,
                            self.cfg.qk_rope_dim, pages=pages,
                            page_size=leaf.shape[2], layout=layout)
            for part in ("dense", "moe"):
                c, kr = lay[part]["c"], lay[part]["kr"]
                for layer, blk in enumerate(getattr(params,
                                                    f"{part}_blocks")):
                    x, _ = _mla_block_chunk(
                        blk, x, {"c": c[layer], "kr": kr[layer]}, cur,
                        n_new, self.cfg, plan=plan,
                        w_kv=None if aux is None else aux[part][layer])
            return rmsnorm(params.final_ln, x, self.cfg.norm_eps), n_new
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        s = kc.shape[2] if pages is None else pages.shape[1] * kc.shape[2]
        plan = StepPlan(cur, n_new, tokens.shape[1], s, self.cfg.head_dim,
                        pages=pages, page_size=kc.shape[2], layout=layout)
        for layer, (blk, (window, theta)) in enumerate(
                zip(params.blocks, self._layer_extras())):
            x, _ = _gqa_block_chunk(blk, x, {"k": kc[layer], "v": vc[layer]},
                                    cur, n_new, self.cfg, window=window,
                                    theta=theta, plan=plan)
        return rmsnorm(params.final_ln, x, self.cfg.norm_eps), n_new

    def _rwkv_ragged(self, params: LMParams, cache, x, n_new):
        """rwkv's ragged layer stack: each layer's carries and WKV state
        advance by the slot's own count, written into the cache in place
        (an idle slot's bit for bit: its rows are identity)."""
        cfg, lay = self.cfg, cache["layers"]
        rcfg = _rwkv_cfg(cfg)
        for layer, blk in enumerate(params.blocks):
            y, (tp, wkv) = rwkv6_time_mix_ragged(
                blk["mix"], rmsnorm(blk["ln1"], x),
                (lay["tm_prev"][layer], lay["wkv"][layer]), n_new, rcfg)
            x = x + y
            y, cp = rwkv6_channel_mix_ragged(
                blk["mix"], rmsnorm(blk["ln2"], x), lay["cm_prev"][layer],
                n_new, rcfg)
            x = x + y
            for name, t in (("tm_prev", tp), ("wkv", wkv), ("cm_prev", cp)):
                lay[name][layer].copy_(t)
        return rmsnorm(params.final_ln, x, cfg.norm_eps)

    def _hybrid_ragged(self, params: LMParams, cache, x, n_new):
        """mamba_hybrid's ragged layer stack: the Mamba2 states advance in
        place as rwkv's do; the shared block's K/V of group g is the
        cache's entry g (contiguous or paged)."""
        cfg, lay = self.cfg, cache["layers"]
        mcfg = _mamba_cfg(cfg)
        pages = cache.get("pages")
        kc, vc = lay["k"], lay["v"]
        s = kc.shape[2] if pages is None else pages.shape[1] * kc.shape[2]
        plan = StepPlan(cache["len"], n_new, x.shape[1], s, cfg.head_dim,
                        pages=pages, page_size=kc.shape[2])

        def mamba(blk, st):
            y, new = mamba2_chunk_step(
                blk, x, {"conv": st["conv"], "ssm": st["ssm"]}, n_new, mcfg)
            for name in ("conv", "ssm"):
                st[name].copy_(new[name])
            return x + y

        for g, gblk in enumerate(params.mamba_groups):
            for j, blk in enumerate(gblk):
                x = mamba(blk, {k: v[g, j] for k, v in lay["groups"].items()})
            x, _ = _gqa_block_chunk(params.shared_attn, x,
                                    {"k": kc[g], "v": vc[g]}, cache["len"],
                                    n_new, cfg, plan=plan)
        for j, blk in enumerate(params.mamba_tail):
            x = mamba(blk, {k: v[j] for k, v in lay["tail"].items()})
        return rmsnorm(params.final_ln, x, cfg.norm_eps)

    def _encdec_ragged(self, params: LMParams, cache, x, n_new):
        """encdec's ragged decoder stack: each layer's self-attention
        inserts into the self K/V (contiguous or paged), its
        cross-attention reads the frozen cross cache up to each slot's
        cross ``len`` (read from the cache, so a captured step sees each
        admission's), and the MLP; the cross cache is never written
        here."""
        cfg, lay = self.cfg, cache["layers"]
        acfg = _attn_cfg(cfg)
        pages = cache.get("pages")
        kc, vc = lay["self"]["k"], lay["self"]["v"]
        cross = lay["cross"]
        s = kc.shape[2] if pages is None else pages.shape[1] * kc.shape[2]
        plan = StepPlan(cache["len"], n_new, x.shape[1], s, cfg.head_dim,
                        pages=pages, page_size=kc.shape[2])
        for layer, blk in enumerate(params.dec_blocks):
            a, _ = gqa_prefill_chunk(blk["attn"], rmsnorm(blk["ln1"], x),
                                     {"k": kc[layer], "v": vc[layer]},
                                     cache["len"], n_new, acfg, plan=plan)
            x = x + a
            x = x + cross_chunk(blk["cross"], rmsnorm(blk["ln2"], x),
                                cross["k"][layer], cross["v"][layer],
                                cross["len"], acfg)
            x = x + mlp_apply(blk["mlp"], rmsnorm(blk["ln3"], x), cfg.act)
        return rmsnorm(params.final_ln, x, cfg.norm_eps)

    # ---------------- serving: prefill + greedy decode ----------------

    def merge_prefill_cache(self, prefill_cache, decode_cache):
        """Embed a :meth:`prefill` cache into a full-capacity decode cache,
        in place (the decode cache keeps its addresses): equal shapes carry
        over, smaller leaves are zero-padded up to the decode layout (cast
        to the decode cache's dtype).  Returns ``decode_cache``."""
        if isinstance(prefill_cache, dict):
            for k in decode_cache:
                self.merge_prefill_cache(prefill_cache[k], decode_cache[k])
            return decode_cache
        p, c = prefill_cache, decode_cache
        if p.ndim != c.ndim or any(ps > cs for ps, cs in zip(p.shape,
                                                              c.shape)):
            raise ValueError(f"prefill leaf {tuple(p.shape)} does not fit "
                             f"the decode leaf {tuple(c.shape)}")
        if p.shape != c.shape:
            c.zero_()
        c[tuple(slice(0, n) for n in p.shape)] = p.to(c.dtype)
        return c

    @torch.no_grad()
    def generate(self, params: LMParams, cache, logits, gen_len: int,
                 graphs: StepGraphs):
        """Greedy decode: token t+1 = argmax of step t's logits, starting
        from ``logits`` (from :meth:`prefill`).  Returns (tokens
        [B, gen_len] int32, the cache, advanced in place); the tokens stay
        on the device until the caller reads them.

        Each step runs through ``graphs`` (a
        :class:`~repro_torch.runtime.graphs.StepGraphs`): on CUDA one
        replay of the captured decode step a token, the
        counterpart of the reference's ``lax.scan``, unless ``graphs`` was
        built eager; on the CPU the same step eagerly.  The step reads the
        token from a static buffer, writes its argmax back there and into
        the output column a device counter names, and advances the counter
        and the cache, all in place: the host issues one replay a token.
        ``graphs`` is keyed by the cache's shapes and addresses and the
        output's width: a reused one replays when given the same cache
        tensors (as :func:`repro_torch.launch.serve.make_graph_generator`
        keeps them), and raises ``ValueError`` when given another
        ``params`` tree for a captured key (the graph holds the weights it
        was captured with)."""
        tok = logits.argmax(dim=-1).to(torch.int32)  # [B]
        if gen_len <= 0:
            return torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                               device=tok.device), cache
        leaves = cache_leaves(cache["layers"])
        # the cache's addresses are part of the key: a graph replays on the
        # tensors it was captured on
        key = ("decode", *(tuple(t.shape) for t in leaves), leaves[0].dtype,
               gen_len, *(t.data_ptr() for t in (*leaves, cache["len"])))
        # mla_moe's absorbed weights, once per captured key (the graph
        # reads the tensors it was captured with) or, eager, once a call
        aux = graphs.held(("aux",) + key,
                          lambda: self.absorbed_weights(params))
        b = tok.shape[0]
        st = graphs.buffers(key, tok=np.zeros((b,), np.int32),
                            pos=np.zeros((1,), np.int64),
                            out=np.zeros((b, gen_len), np.int32))
        st["tok"].copy_(tok)
        st["out"][:, 0] = tok
        st["pos"].fill_(1)

        def step():
            lg, _ = self.decode_step(params, cache, st["tok"][:, None],
                                     aux=aux)
            nxt = lg.argmax(dim=-1).to(torch.int32)
            st["tok"].copy_(nxt)
            # clamped: a replay past the last column (a profiler's)
            # rewrites it rather than writing past the buffer
            st["out"].index_copy_(1, st["pos"].clamp(max=gen_len - 1),
                                  nxt[:, None])
            st["pos"].add_(1)

        for _ in range(gen_len - 1):
            graphs(key, step, binds=(params,))
        return st["out"].clone(), cache
