"""Architecture config schema (counterpart of ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.schemes import PolicyTree, QuantPolicy


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # gqa | gqa_moe | mla_moe | mamba_hybrid | rwkv | encdec
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
    # moe (n_dense_layers: mla_moe's leading layers with a dense MLP)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    routing: str = "softmax"              # softmax | sigmoid (aux-free)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01                # weight of the MoE aux in the loss
    moe_chunk: int = 512                  # prefill positions a routing chunk
    # mla (DeepSeek multi-head latent attention) and its MTP head
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False
    # ssm / hybrid: Mamba2's state size N, the Mamba2 / WKV head dim, the
    # hybrid's period (the shared attention block after every
    # attn_every - 1 Mamba2 layers) and the chunk of the chunked scans
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0
    ssm_chunk: int = 128
    # enc-dec: the encoder's depth (n_layers is the decoder's), and the
    # share of a training sequence (and of a decode cache made without an
    # explicit source capacity) that is source frames
    n_enc_layers: int = 0
    source_frac: float = 0.5
    gated_mlp: bool = True
    act: str = "silu"
    # frontend stub ("vision", "audio" or None): precomputed embeddings.
    # "vision": patch embeddings given as batch["frontend"] [B,
    # frontend_len, d_model], prepended to the token embeddings
    # (pixtral-12b); "audio": the encoder's frames, batch["src"] [B, Ss,
    # d_model] (seamless-m4t-medium)
    frontend: Optional[str] = None
    frontend_len: int = 256
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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic attention run long_500k
SUBQUADRATIC = {"gemma3-1b", "h2o-danube-1.8b", "zamba2-7b", "mixtral-8x22b",
                "rwkv6-7b"}


def cells_for(arch_name: str):
    """The shape cells an arch runs (long_500k only when sub-quadratic)."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or arch_name in SUBQUADRATIC]
