"""Architecture config schema (counterpart of ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.schemes import PolicyTree, QuantPolicy


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # gqa | gqa_moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention
    rope_theta: float = 1e4
    window: Optional[int] = None          # sliding-window size (SWA archs)
    global_every: int = 0                 # gemma3: every Nth layer is global
    global_rope_theta: float = 1e6
    qk_norm: bool = False
    # moe (n_dense_layers waits for the slice that reads it: mla_moe)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    routing: str = "softmax"              # softmax | sigmoid (aux-free)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01                # weight of the MoE aux in the loss
    moe_chunk: int = 512                  # prefill positions a routing chunk
    gated_mlp: bool = True
    act: str = "silu"
    # policy: uniform QuantPolicy or per-layer PolicyTree
    quant: Union[QuantPolicy, PolicyTree] = QuantPolicy()
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # recompute each block's activations in the backward (training)
    remat: bool = True
    # attention chunking (flash)
    chunk_q: int = 256
    chunk_k: int = 1024
    # loss: sequence positions per cross-entropy chunk
    xent_chunk: int = 512

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
