"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free, 64 heads of
64), data-dependent decay, d_ff=14336, vocab=65536 [arXiv:2404.05892]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # nominal; WKV heads = d_model / ssm_head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    ssm_head_dim=64,
    ssm_chunk=64,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
