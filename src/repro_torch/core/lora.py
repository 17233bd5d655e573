"""The baselines the paper compares against: LoRA, QLoRA, QLoRA + PTQ
(PyTorch counterpart of ``repro.core.lora``).

* LoRA (Hu et al., 2021): a float base weight plus an unconstrained
  ``A [D_in, r]``, ``B [r, D_out]``; the merge gives a float weight.
* QLoRA (Dettmers et al., 2023): an NF4 base plus an unconstrained LoRA.
  Its merge necessarily gives a float weight (the adapter's delta is not
  constant within a quantization group, so it cannot fold into the
  quantization parameters); deploying it quantized takes a post-training
  quantization, the accuracy loss that QA-LoRA removes (paper Fig. 1,
  Table 1).

Plain PyTorch products, as in the reference (no kernel computes them).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .nf4 import NF4Tensor, nf4_dequantize, nf4_quantize
from .quant import QuantizedLinear, quantize

__all__ = ["LoRAParams", "init_lora", "lora_forward", "lora_merge",
           "qlora_quantize_base", "qlora_forward", "qlora_merge_fp",
           "qlora_merge_ptq"]


class LoRAParams(nn.Module):
    """Trainable adapter of one linear: ``a [D_in, r]``, ``b [r, D_out]``."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


def init_lora(generator: torch.Generator, d_in: int, rank: int, d_out: int,
              dtype=torch.float32, device="cuda") -> LoRAParams:
    """A ~ N(0, 1 / D_in), B = 0 (the adapter starts as the identity)."""
    a = torch.randn((d_in, rank), generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / math.sqrt(d_in))
    b = torch.zeros((rank, d_out), dtype=dtype, device=device)
    return LoRAParams(a.to(dtype), b)


def lora_forward(x, w, p: LoRAParams, s: float):
    return x @ w + (x @ p.a.to(x.dtype)) @ p.b.to(x.dtype) * s


@torch.no_grad()
def lora_merge(w, p: LoRAParams, s: float):
    """``w + s * A @ B`` (the product in f32, added in ``w``'s dtype)."""
    return w + (p.a.to(torch.float32) @ p.b.to(torch.float32) * s).to(w.dtype)


def qlora_quantize_base(w, block: int = 64) -> NF4Tensor:
    return nf4_quantize(w, block=block)


def qlora_forward(x, nf4: NF4Tensor, p: LoRAParams, s: float):
    return lora_forward(x, nf4_dequantize(nf4, x.dtype), p, s)


def qlora_merge_fp(nf4: NF4Tensor, p: LoRAParams, s: float):
    """The QLoRA merge: a float weight (the '4+16' row of Table 1)."""
    return lora_merge(nf4_dequantize(nf4), p, s)


def qlora_merge_ptq(nf4: NF4Tensor, p: LoRAParams, s: float, bits: int,
                    group_size: int, quantizer=None) -> QuantizedLinear:
    """The 'QLoRA w/ GPTQ' baseline: merge to a float weight, then
    post-training quantize it (RTN unless ``quantizer``, e.g. a GPTQ
    closure ``w -> QuantizedLinear``, is given).  Lossy, unlike QA-LoRA's
    merge: the paper's central contrast."""
    w = qlora_merge_fp(nf4, p, s)
    qfn = quantizer or (lambda w_: quantize(w_, bits, group_size))
    return qfn(w)
