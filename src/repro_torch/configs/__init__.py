"""Config registry: ``get(name)`` returns the full config, ``reduced(name)``
a same-family CPU-smoke-size config (counterpart of ``repro.configs``;
every arch of the reference is registered)."""

from __future__ import annotations

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import SHAPES, SUBQUADRATIC, ArchConfig, ShapeCell, cells_for

from . import (deepseek_67b, deepseek_v3_671b, gemma3_1b, h2o_danube_1_8b,
               llama7b_proxy, mixtral_8x22b, pixtral_12b, rwkv6_7b,
               seamless_m4t_medium, starcoder2_7b, zamba2_7b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    pixtral_12b, gemma3_1b, starcoder2_7b, h2o_danube_1_8b, deepseek_67b,
    seamless_m4t_medium, zamba2_7b, mixtral_8x22b, deepseek_v3_671b,
    rwkv6_7b, llama7b_proxy)}

# the configs of the dry run (llama7b-proxy is the paper's stand-in)
ASSIGNED = [n for n in REGISTRY if n != "llama7b-proxy"]


def get(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"arch {name!r} is not ported yet (see ROADMAP.md); "
                       f"ported: {sorted(REGISTRY)}")


SMOKE_QUANT = QuantPolicy(bits=4, group_size=16, rank=4, dtype=torch.float32,
                          scale_dtype=torch.float32)


def reduced(name: str, **over) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests, with the reference's
    reductions (layers, width, experts, vocab, window, frontend length,
    chunks, the MLA ranks and dims, the SSM state and head dims, the
    encoder's depth, no remat)."""
    cfg = get(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16, d_ff=96,
        vocab=256, window=min(cfg.window or 0, 8) or None, frontend_len=8,
        chunk_q=16, chunk_k=16, xent_chunk=16, moe_chunk=16, ssm_chunk=16,
        quant=SMOKE_QUANT, remat=False,
    )
    if cfg.family in ("gqa_moe", "mla_moe"):
        kw.update(n_experts=4, top_k=2, moe_d_ff=32,
                  n_shared_experts=cfg.n_shared_experts)
    if cfg.family == "mla_moe":
        kw.update(n_layers=3, n_dense_layers=1, q_lora_rank=32,
                  kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16,
                  v_head_dim=16)
    if cfg.family == "mamba_hybrid":
        kw.update(n_layers=5, attn_every=2, ssm_state=16, ssm_head_dim=16)
    if cfg.family == "rwkv":
        kw.update(ssm_head_dim=16)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.global_every:
        kw.update(global_every=2)
    kw.update(over)
    return cfg.scaled(**kw)


__all__ = ["ASSIGNED", "ArchConfig", "REGISTRY", "SHAPES", "SMOKE_QUANT",
           "SUBQUADRATIC", "ShapeCell", "cells_for", "get", "reduced"]
