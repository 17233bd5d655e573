"""AdamW + schedules + global-norm clipping over ``name -> tensor`` dicts
(counterpart of ``repro.optim.adamw``, written as the reference writes it).

The paper's recipe (Sec. 4.1): AdamW, max grad-norm 0.3, a constant LR,
batch 16.  With QA-LoRA the trainable state is only the adapters, so the
moments are small.  As in the reference:

* the moments are f32 whatever the parameter's dtype, and the update is
  computed in f32 and cast to the parameter's dtype (so a bf16 parameter
  moves only where the update reaches half a bf16 step of its value);
* the clip scale is ``min(1, max_norm / max(norm, 1e-9))`` and the clipped
  gradient is cast back to the gradient's dtype;
* the step counter and the learning rate are f32 device scalars, so a
  step never waits for the host.

``torch.optim.AdamW`` keeps its moments in the parameter's dtype, so it is
no counterpart.  :func:`adamw_update` writes the parameters and the state
in place under ``torch.no_grad()``; every tensor keeps its storage (the
kernels read the adapters through raw pointers and need them contiguous).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 0.3
    schedule: str = "constant"   # constant | cosine | warmup_cosine
    total_steps: int = 10_000
    warmup_steps: int = 0


def constant_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    return torch.full((), cfg.lr, dtype=torch.float32, device=step.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    frac = (step.to(torch.float32) / max(cfg.total_steps, 1)).clamp(0.0, 1.0)
    return cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * frac))


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    w = max(cfg.warmup_steps, 1)
    warm = cfg.lr * torch.clamp(step.to(torch.float32) / w, max=1.0)
    return torch.where(step < w, warm, cosine_schedule(cfg, step - w))


_SCHEDULES = {"constant": constant_schedule, "cosine": cosine_schedule,
              "warmup_cosine": warmup_cosine}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32 (0 when empty)."""
    sums = [t.to(torch.float32).square().sum() for t in tensors.values()]
    if not sums:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm(tensors: Tensors, max_norm: float):
    """(clipped copies, norm): each tensor times ``min(1, max_norm /
    max(norm, 1e-9))`` in f32, cast back to its dtype."""
    n = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: (t.to(torch.float32) * scale).to(t.dtype)
            for k, t in tensors.items()}, n


def adamw_init(params: Tensors) -> dict:
    """Zero f32 moments beside each parameter, and an int32 step of 0."""
    first = next(iter(params.values()), None)
    device = first.device if first is not None else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, state: dict,
                 params: Tensors) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``state`` (``grads`` and
    ``params`` keyed alike).  Returns the metrics ``grad_norm`` (before the
    clip) and ``lr`` (this step's), as f32 device scalars."""
    if set(grads) != set(params):
        raise ValueError(f"grads and params differ in keys: "
                         f"{sorted(set(grads) ^ set(params))[:4]}")
    if cfg.max_grad_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    else:
        gnorm = global_norm(grads)
    state["step"] += 1
    step = state["step"]
    lr = _SCHEDULES[cfg.schedule](cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=step.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=step.device), stepf)
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        mu, nu = state["mu"][k], state["nu"][k]
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g.square())
        delta = (mu / c1) / ((nu / c2).sqrt() + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "warmup_cosine"]
