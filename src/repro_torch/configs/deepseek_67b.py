"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) head_dim=128
d_ff=22016 vocab=102400, llama-style [arXiv:2401.02954]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="gqa",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    rope_theta=1e4,
    # the reference's prefill attention tiles (``chunk_q`` / ``chunk_k``)
    chunk_q=512,
    chunk_k=2048,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
