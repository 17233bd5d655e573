"""pixtral-12b [vlm] — Pixtral ViT frontend (stub) + Mistral-Nemo backbone.

40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  The vision tower is a stub:
the batch supplies ``frontend_len`` precomputed patch embeddings
(``batch["frontend"]``), which the LM prepends to the token embeddings."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="gqa",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    frontend="vision",
    frontend_len=256,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
