"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) head_dim=80
d_ff=6912 vocab=32000; llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="gqa",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    window=4096,
    rope_theta=1e4,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
