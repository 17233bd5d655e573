"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 backbone (ssm_state=64)
with one shared attention+MLP block applied after every 5 Mamba2 layers
(32H kv=32 of 112, d_ff=14336, vocab=32000) [arXiv:2411.15242].  The
shared block's quantized base is stored once and applied n_layers // 6
times."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="mamba_hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=1e4,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
