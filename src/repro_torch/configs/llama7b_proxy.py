"""llama7b-proxy — the paper's own foundation family (LLaMA-7B geometry):
32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000, INT4 g32 r64, bf16."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama7b-proxy",
    family="gqa",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=32000,
    rope_theta=1e4,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
