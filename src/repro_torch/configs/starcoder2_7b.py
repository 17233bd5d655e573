"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) head_dim=128
d_ff=18432 vocab=49152, GQA + RoPE, non-gated GELU MLP [arXiv:2402.19173]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="gqa",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    rope_theta=1e5,
    gated_mlp=False,
    act="gelu",
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
