"""Shared building blocks: norms, activations, rotary embedding
(counterpart of ``repro.models.common``; the sharding constraints there
have no counterpart on one card)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class RMSNorm(nn.Module):
    """RMSNorm weight holder: buffer ``g [d]``."""

    def __init__(self, g: torch.Tensor):
        super().__init__()
        self.register_buffer("g", g)


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.g.to(torch.float32)).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def rope_table(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """(cos, sin), each [..., seq, 1, head_dim // 2], for :func:`rope`."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., seq, half]
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
         table=None):
    """Rotary embedding. x: [..., seq, n_heads, head_dim];
    positions: [..., seq].  ``table`` is a precomputed :func:`rope_table`
    for these positions and theta."""
    half = x.shape[-1] // 2
    cos, sin = table if table is not None else rope_table(
        positions, x.shape[-1], theta)
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)
