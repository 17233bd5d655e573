"""seamless-m4t-medium [audio] — enc-dec, 12+12L d_model=1024 16H (kv=16)
head_dim=64 d_ff=4096 (ReLU, not gated) vocab=256206 [arXiv:2308.11596].
The audio frontend is a stub: the encoder takes precomputed frame
embeddings, ``batch["src"]``."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,          # decoder
    n_enc_layers=12,      # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    gated_mlp=False,
    act="relu",
    frontend="audio",
    source_frac=0.5,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
