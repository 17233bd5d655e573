"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) head_dim=128,
MoE: 8 experts top-2, expert d_ff=16384, vocab=32768, SWA
[arXiv:2401.04088]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="gqa_moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    n_experts=8,
    top_k=2,
    routing="softmax",
    vocab=32768,
    window=4096,
    rope_theta=1e6,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
