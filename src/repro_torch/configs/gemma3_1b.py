"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) head_dim=256
d_ff=6912 vocab=262144, 5:1 local(512-window):global interleave, dual rope
theta (10k local / 1M global), qk-norm [hf:google/gemma-3-1b-pt]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="gqa",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    window=512,
    global_every=6,       # every 6th layer is global
    rope_theta=1e4,
    global_rope_theta=1e6,
    qk_norm=True,
    act="gelu",
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
