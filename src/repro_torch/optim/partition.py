"""Trainable/frozen parameter partition (counterpart of
``repro.optim.partition``).

QA-LoRA trains ONLY the adapters.  Which tensors are adapters is decided
by each linear's registered scheme (``scheme.trainable_paths``, through
:func:`repro_torch.core.schemes.trainable_tensors`), not by sniffing
names.  The quantized base, embedding, norms and head stay frozen: they
are buffers of the params module, so autograd builds no gradient for them
and the optimizer never sees them.

The reference's ``merge_params`` has no counterpart: a module tree holds
its trainable tensors in place, so the two halves of :func:`split_params`
are views into one tree, never two trees to put back together.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.core.schemes import trainable_tensors


def split_params(params: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """(trainable, frozen): ``name -> tensor`` dicts over the same module,
    the adapters (its parameters) and every buffer."""
    return trainable_tensors(params), dict(params.named_buffers())


def count_params(tree) -> int:
    """Elements in a module or a (nested) dict of tensors."""
    if isinstance(tree, nn.Module):
        return sum(t.numel() for t in tree.parameters()) + sum(
            t.numel() for t in tree.buffers())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


__all__ = ["split_params", "count_params", "trainable_tensors"]
