"""Gated MLP (SwiGLU / GeGLU), counterpart of ``repro.models.mlp``."""

from __future__ import annotations

from torch import nn

from repro_torch.core.schemes import linear_apply, linear_init
from .common import act_fn


def mlp_init(generator, d_model: int, d_ff: int, pol, gated: bool = True,
             device="cuda") -> nn.ModuleDict:
    p = nn.ModuleDict()
    if gated:
        p["gate"] = linear_init(generator, d_model, d_ff, pol.at("gate"), device)
    p["up"] = linear_init(generator, d_model, d_ff, pol.at("up"), device)
    p["down"] = linear_init(generator, d_ff, d_model, pol.at("down"), device)
    return p


def mlp_apply(p: nn.ModuleDict, x, act: str = "silu"):
    u = linear_apply(p["up"], x)
    if "gate" in p:
        h = act_fn(act)(linear_apply(p["gate"], x)) * u
    else:
        h = act_fn(act)(u)
    return linear_apply(p["down"], h)
