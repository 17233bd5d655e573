"""The gqa decoder LM: init, the training loss, prefill, ragged decode step
and greedy generation.  Counterpart of the gqa family of
``repro.models.lm``.

Parameters are an :class:`LMParams` module: the embedding, the final norm,
the head (fp, or under an explicit ``lm_head`` policy rule any scheme,
through the same kernels as the blocks' linears) and one block per layer
in a ``ModuleList`` (the reference stacks layers on a leading axis and
scans; here a Python loop walks the list).  Every projection routes through the linear-scheme API, so a
``qalora`` model, its merged ``intq`` model and the kernel routing are
policy switches.

Batch format: ``{"tokens": [B, S] int}``, plus ``"labels"`` ([B, S] int,
-1 = not supervised) for :meth:`LM.loss`, which runs with autograd on and
recomputes each block in the backward when ``cfg.remat``; prefill and
decode run under ``torch.no_grad``.  Decode caches follow
:class:`repro_torch.models.slot_state.SlotState`; decode steps write their
K/V and lengths into the cache they are given, in place, and return it.
"""

from __future__ import annotations

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
from .attention import StepPlan, gqa_apply, gqa_init, gqa_prefill_chunk
from .common import rmsnorm, rmsnorm_init
from .mlp import mlp_apply, mlp_init
from .slot_state import SlotState, attn_cfg as _attn_cfg


class LMParams(nn.Module):
    """Model parameters: buffer ``embed [V, d]``, ``final_ln``, ``head``
    (a tagged linear ``[d, V]``, None when tied) and ``blocks``."""

    def __init__(self, embed: torch.Tensor, final_ln: nn.Module,
                 head: Optional[schemes.LinearParams], blocks: List[nn.Module]):
        super().__init__()
        self.register_buffer("embed", embed)
        self.final_ln = final_ln
        self.head = head
        self.blocks = nn.ModuleList(blocks)


def _gqa_block_init(generator, cfg: ArchConfig, pol, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(generator, _attn_cfg(cfg), pol.at("attn"), device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, pol.at("mlp"),
                        cfg.gated_mlp, device),
    })


def _gqa_block(p, x, cfg: ArchConfig, *, window=None, theta=None):
    a, kv = gqa_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                      _attn_cfg(cfg), window=window, theta=theta,
                      chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    x = x + a
    m = mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x + m, kv


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint`` in the reference) when ``cfg.remat``."""
    if not cfg.remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _gqa_block_train(p, x, cfg: ArchConfig, window, theta):
    return _gqa_block(p, x, cfg, window=window, theta=theta)[0]


def _gqa_block_chunk(p, x, cache, cur_len, n_new, cfg: ArchConfig, *,
                     window=None, theta=None, plan=None):
    """Ragged chunk through one block: x [B,C,d], per-slot n_new consumed."""
    a, cache = gqa_prefill_chunk(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cache, cur_len, n_new, _attn_cfg(cfg),
                                 window=window, theta=theta, plan=plan)
    x = x + a
    m = mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x + m, cache


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
        if self.cfg.family != "gqa":
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (see "
                f"ROADMAP.md); the port serves gqa")

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
        bpol = pol.at("blocks")
        blocks = [_gqa_block_init(generator, cfg, bpol, dev)
                  for _ in range(cfg.n_layers)]
        return LMParams(embed, rmsnorm_init(d, device=dev), head, blocks)

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
        return params.embed[tokens.to(torch.int64)]

    def _logits(self, params: LMParams, h):
        if self.cfg.tie_embeddings:
            return (h @ params.embed.T.to(h.dtype)).to(torch.float32)
        return schemes.linear_apply(params.head, h).to(torch.float32)

    def _xent(self, params: LMParams, h, labels):
        """Chunked softmax cross-entropy over ``cfg.xent_chunk`` positions
        at a time (never ``[B, S, V]`` logits at once): labels < 0 are
        masked, and the mean is ``loss_sum / max(n, 1)``.  Each chunk's
        logits come from :meth:`_logits`, so a quantized head runs its
        scheme's kernel (the reference multiplies by the head's dense
        view: the same product, another order of sums)."""
        s = h.shape[1]
        c = min(self.cfg.xent_chunk, s)
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of xent_chunk "
                             f"{c}")
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        n = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s, c):
            logits = self._logits(params, h[:, i:i + c])
            yc = labels[:, i:i + c].to(torch.int64)
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, yc.clamp(min=0)[..., None])[..., 0]
            mask = (yc >= 0).to(torch.float32)
            loss_sum = loss_sum + ((lse - ll) * mask).sum()
            n = n + mask.sum()
        return loss_sum / n.clamp(min=1.0)

    def _trunk(self, params: LMParams, x, collect_cache: bool = False):
        """Runs the layer stack.  Returns (h, cache or None)."""
        ks, vs = [], []
        for blk, (window, theta) in zip(params.blocks, self._layer_extras()):
            x, (k, v) = _gqa_block(blk, x, self.cfg, window=window, theta=theta)
            if collect_cache:
                ks.append(k)
                vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
            if collect_cache else None
        return x, cache

    # ---------------- public API ----------------

    def loss(self, params: LMParams, batch: Dict[str, Any]):
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, [B, S]), with autograd on.  Returns (loss, {"xent",
        "aux"}); gqa has no auxiliary loss, so aux is 0."""
        x = self._embed(params, batch["tokens"])
        for blk, (window, theta) in zip(params.blocks, self._layer_extras()):
            block = functools.partial(_gqa_block_train, cfg=self.cfg,
                                      window=window, theta=theta)
            x = _maybe_remat(block, self.cfg)(blk, x)
        h = rmsnorm(params.final_ln, x, self.cfg.norm_eps)
        xent = self._xent(params, h, batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=xent.device)
        return xent, {"xent": xent, "aux": aux}

    @torch.no_grad()
    def prefill(self, params: LMParams, batch: Dict[str, Any]):
        """Returns (last-token logits [B, V] f32, cache dict)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        h, cache = self._trunk(params, x, collect_cache=True)
        h = rmsnorm(params.final_ln, h[:, -1:], self.cfg.norm_eps)
        logits = self._logits(params, h)[:, 0]
        length = torch.full((tokens.shape[0],), tokens.shape[1],
                            dtype=torch.int32, device=tokens.device)
        return logits, {"layers": cache, "len": length}

    def slot_state(self) -> SlotState:
        return SlotState(self.cfg)

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        """Fresh decode cache (see :class:`SlotState`)."""
        return self.slot_state().init(batch, seq, dtype=dtype,
                                      device=resolve_device(device))

    def decode_step(self, params: LMParams, cache, tokens):
        """tokens: [B, 1] -> (logits [B, V], updated cache): the C=1
        always-active case of :meth:`step_ragged`."""
        return self.step_ragged(params, cache, tokens,
                                torch.ones_like(cache["len"]))

    @torch.no_grad()
    def step_ragged(self, params: LMParams, cache, tokens, n_new):
        """Ragged serve step: slot b consumes ``tokens[b, :n_new[b]]`` at
        positions ``len[b]..`` and advances by ``n_new[b]``, writing the
        cache in place.  Returns (logits [B, V] at each slot's last consumed
        row, cache)."""
        h, n_new = self._ragged_trunk(params, cache, tokens, n_new)
        last = (n_new.to(torch.int64) - 1).clamp(0, tokens.shape[1] - 1)
        idx = last[:, None, None].expand(h.shape[0], 1, h.shape[2])
        h_last = torch.gather(h, 1, idx)
        logits = self._logits(params, h_last)[:, 0]
        return logits, self.slot_state().advance(cache, n_new)

    def _ragged_trunk(self, params: LMParams, cache, tokens, n_new):
        cur = cache["len"]
        n_new = n_new.to(torch.int32)
        x = self._embed(params, tokens)
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        plan = StepPlan(cur, n_new, tokens.shape[1], kc.shape[2],
                        self.cfg.head_dim)
        for layer, (blk, (window, theta)) in enumerate(
                zip(params.blocks, self._layer_extras())):
            x, _ = _gqa_block_chunk(blk, x, {"k": kc[layer], "v": vc[layer]},
                                    cur, n_new, self.cfg, window=window,
                                    theta=theta, plan=plan)
        return rmsnorm(params.final_ln, x, self.cfg.norm_eps), n_new

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
        kc = cache["layers"]["k"]
        # the cache's addresses are part of the key: a graph replays on the
        # tensors it was captured on
        key = ("decode", tuple(kc.shape), kc.dtype, gen_len,
               *(t.data_ptr() for t in (kc, cache["layers"]["v"],
                                        cache["len"])))
        b = tok.shape[0]
        st = graphs.buffers(key, tok=np.zeros((b,), np.int32),
                            pos=np.zeros((1,), np.int64),
                            out=np.zeros((b, gen_len), np.int32))
        st["tok"].copy_(tok)
        st["out"][:, 0] = tok
        st["pos"].fill_(1)

        def step():
            lg, _ = self.decode_step(params, cache, st["tok"][:, None])
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
