"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA, 1 shared + 256
routed experts top-8 (expert d_ff=2048), 3 dense layers (d_ff=18432),
sigmoid aux-free routing, MTP, vocab=129280 [arXiv:2412.19437]."""

import torch

from repro_torch.core.schemes import QuantPolicy
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,      # nominal (MLA caches the compressed latent instead)
    head_dim=128,
    d_ff=18432,          # dense layers
    moe_d_ff=2048,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    n_dense_layers=3,
    routing="sigmoid",
    mtp=True,
    vocab=129280,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    quant=QuantPolicy(bits=4, group_size=32, rank=64,
                      dtype=torch.bfloat16, scale_dtype=torch.bfloat16),
)
