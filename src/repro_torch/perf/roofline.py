"""Roofline terms of a step on the H100 (counterpart of
``repro.perf.roofline``; the formulas are the reference's, the hardware
is the port's).

Hardware model (NVIDIA H100 SXM5 80GB, data sheet):
  peak_flops     = 989e12  dense bf16 tensor-core FLOP/s
  hbm_bw         = 3.35e12 B/s HBM3
  link_bw        = 450e9   B/s NVLink 4, one direction
  peak_f32_flops = 67e12   f32 FLOP/s without tensor cores (TF32 off: the
                           plain versions' and the attention core's f32
                           products)
  hbm_bytes      = 80e9    B of device memory

A rank's step counted by :class:`repro_torch.perf.cost.CostCounter` (one
card's program: shard shapes on a mesh) gives the terms

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = collective_bytes / link_bw

``roofline_terms`` takes any ``HW`` (the tests pass the reference's TPU
figures to hold the formulas equal).  MODEL_FLOPS is the standard 6 N D
(train) / 2 N D (inference) with N the active parameters; MODEL_FLOPS /
(flops x chips) exposes recompute (remat) and other redundant work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    peak_f32_flops: float = 67e12
    hbm_bytes: float = 80e9


def active_params(cfg) -> int:
    """Analytic active-parameter count (MoE counts shared + top_k experts)."""
    d, L = cfg.d_model, cfg.n_layers
    mlp3 = 3 if cfg.gated_mlp else 2

    if cfg.family == "rwkv":
        per = 5 * d * d + mlp3 * 0 + (d * cfg.d_ff * 2 + d * d)  # tm + cm
        return L * per + 2 * cfg.vocab * d
    if cfg.family == "mamba_hybrid":
        di = 2 * d
        per_mamba = d * (2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim) \
            + di * d
        n_attn = cfg.n_layers // cfg.attn_every
        attn = (d * cfg.n_heads * cfg.head_dim * 2
                + d * cfg.n_kv_heads * cfg.head_dim * 2
                + mlp3 * d * cfg.d_ff)
        n_mamba = cfg.n_layers - n_attn
        return n_mamba * per_mamba + n_attn * attn + 2 * cfg.vocab * d

    # attention side
    if cfg.family == "mla_moe":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qk
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * cfg.n_heads
                * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    else:
        attn = (d * cfg.n_heads * cfg.head_dim * 2
                + d * cfg.n_kv_heads * cfg.head_dim * 2)

    # ffn side
    if cfg.family in ("gqa_moe", "mla_moe"):
        moe_ff = 3 * d * cfg.moe_d_ff  # experts are gated
        active_ffn = (cfg.top_k + cfg.n_shared_experts) * moe_ff
        nd = cfg.n_dense_layers
        dense_ffn = mlp3 * d * cfg.d_ff
        ffn_total = nd * dense_ffn + (L - nd) * active_ffn
        attn_total = L * attn
    else:
        ffn_total = L * mlp3 * d * cfg.d_ff
        attn_total = L * attn
        if cfg.family == "encdec":
            # encoder blocks + decoder cross-attention
            enc = cfg.n_enc_layers * (attn + mlp3 * d * cfg.d_ff)
            attn_total = L * (2 * attn) + L * mlp3 * d * cfg.d_ff + enc
            return attn_total + 2 * cfg.vocab * d
    return attn_total + ffn_total + 2 * cfg.vocab * d


def model_flops(cfg, cell) -> float:
    n = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    tokens = cell.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens


def roofline_terms(per_device, n_devices: int, cfg, cell,
                   hw: HW = HW()) -> Dict[str, float]:
    """The terms of one rank's counted step (anything with ``flops``,
    ``bytes`` and ``collective_bytes``) on ``n_devices`` chips."""
    compute = per_device.flops / hw.peak_flops
    memory = per_device.bytes / hw.hbm_bw
    collective = per_device.collective_bytes / hw.link_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    hlo_total = per_device.flops * n_devices
    return {
        **terms,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "chips": n_devices,
    }


__all__ = ["HW", "active_params", "model_flops", "roofline_terms"]
