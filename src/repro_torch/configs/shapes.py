"""Abstract inputs for every (architecture x shape) cell (counterpart of
``repro.configs.shapes``): tensors on the ``meta`` device, so nothing is
allocated.  Each has the reference's ``ShapeDtypeStruct`` shape, in the
port's dtype for it.

``input_specs(cfg, cell)`` returns (step_kind, kwargs), the kwargs of the
train step (``batch``), of ``LM.prefill`` (``batch``) or of
``LM.decode_step`` (``cache``, ``tokens``).  The frontend stubs are the
reference's: a vision config's batch carries ``frontend_len`` rows of
patch embeddings, an enc-dec config's ``source_frac`` of the sequence as
the source frames ``src``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.lm import LM

META = torch.device("meta")


def _s(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, cell: ShapeCell, with_labels: bool = True):
    b, s = cell.global_batch, cell.seq_len
    dt = cfg.quant.dtype
    if cfg.family == "encdec":
        src_len = int(s * cfg.source_frac)
        tgt = s - src_len
        out = {"tokens": _s((b, tgt), torch.int32),
               "src": _s((b, src_len, cfg.d_model), dt)}
    elif cfg.frontend == "vision":
        tgt = s - cfg.frontend_len
        out = {"tokens": _s((b, tgt), torch.int32),
               "frontend": _s((b, cfg.frontend_len, cfg.d_model), dt)}
    else:
        tgt = s
        out = {"tokens": _s((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _s((b, tgt), torch.int32)
    return out


def cache_specs(cfg: ArchConfig, cell: ShapeCell):
    """``LM.init_cache`` of the cell's batch and length, on ``meta``."""
    return LM(cfg).init_cache(cell.global_batch, cell.seq_len, device=META)


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Tuple[str, Dict[str, Any]]:
    if cell.kind == "train":
        return "train", {"batch": batch_specs(cfg, cell, with_labels=True)}
    if cell.kind == "prefill":
        return "prefill", {"batch": batch_specs(cfg, cell, with_labels=False)}
    if cell.kind == "decode":
        return "decode", {
            "cache": cache_specs(cfg, cell),
            "tokens": _s((cell.global_batch, 1), torch.int32),
        }
    raise ValueError(cell.kind)


__all__ = ["batch_specs", "cache_specs", "input_specs"]
