"""QA-LoRA (paper Sec. 3.3 + Appendix B), PyTorch counterpart of
``repro.core.qalora``.

A frozen group-wise-quantized base linear plus a group-pooled adapter:

    y = x @ dequant(W_q)  +  s * pool_sum(x) @ A @ B

``pool_sum`` sums activations within each quantization group, ``A`` is
``[L, r]`` and ``B`` is ``[r, D_out]``.  The adapter's effective weight is
constant within each group, so it folds exactly into the zero points:

    zero' = zero + s * (A @ B)

and the merged model keeps its integer codes and scales.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .quant import QuantizedLinear, dequantize, quantize


class QALoRAParams(nn.Module):
    """Trainable adapter state for one linear layer: ``a [L, r]``,
    ``b [r, D_out]``."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


def init_qalora(generator: torch.Generator, n_groups: int, rank: int,
                d_out: int, dtype=torch.float32, device="cuda") -> QALoRAParams:
    """Standard LoRA init: A ~ N(0, 1/L), B = 0 (the adapter starts as the
    identity)."""
    a = torch.randn((n_groups, rank), generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / math.sqrt(n_groups))
    b = torch.zeros((rank, d_out), dtype=dtype, device=device)
    return QALoRAParams(a.to(dtype), b)


def group_pool(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """Sum-pool the trailing feature dim over quantization groups:
    ``[..., D_in] -> [..., D_in // group_size]``."""
    *lead, d_in = x.shape
    assert d_in % group_size == 0, (d_in, group_size)
    return x.reshape(*lead, d_in // group_size, group_size).sum(dim=-1)


def adapter_delta(x: torch.Tensor, p: QALoRAParams, s: float,
                  group_size: int) -> torch.Tensor:
    """The QA-LoRA side path: ``s * pool_sum(x) @ A @ B``."""
    pooled = group_pool(x, group_size)
    return (pooled @ p.a.to(x.dtype)) @ p.b.to(x.dtype) * s


def bank_adapter_delta(x: torch.Tensor, a_bank: torch.Tensor,
                       b_bank: torch.Tensor, ids: torch.Tensor, s: float,
                       group_size: int) -> torch.Tensor:
    """Per-row adapter delta from stacked banks (multi-tenant serving).

    ``a_bank [N, L, r]`` / ``b_bank [N, r, D_out]`` stack N adapters;
    ``ids [B]`` picks one per leading row of ``x [B, ..., D_in]``, whose
    delta is ``s * pool(x_b) @ A[ids_b] @ B[ids_b]``.  Bank row 0 is the
    null adapter (zeros, delta exactly 0).

    The reference gathers ``[B, r, D_out]`` copies of B; at prefill M that
    is hundreds of MB per linear.  Here each row contracts with every
    adapter's A (``[B, ..., N, r]``), the rows of other adapters are set to
    exact zeros, and one product with the ``[N * r, D_out]`` stack of B
    adds only the row's own adapter: the same f32 products and sums, in
    another order.  Pooling and both products run in f32; the result is
    cast to ``x.dtype``."""
    f32 = torch.float32
    n, _, rank = a_bank.shape
    pooled = group_pool(x.to(f32), group_size)             # [B, ..., L]
    t = torch.einsum("b...l,nlr->b...nr", pooled, a_bank.to(f32))
    own = ids.to(torch.int64)[:, None] == torch.arange(n, device=ids.device)
    own = own.reshape(own.shape[:1] + (1,) * (t.dim() - 3) + (n, 1))
    t = torch.where(own, t, 0.0).flatten(-2)               # [B, ..., N*r]
    delta = t @ b_bank.to(f32).reshape(n * rank, -1)
    return (delta * s).to(x.dtype)


def qalora_forward(x: torch.Tensor, qt: QuantizedLinear, p: QALoRAParams,
                   s: float, compute_dtype=None) -> torch.Tensor:
    """Plain fine-tuning / serving forward (no kernel)."""
    dtype = compute_dtype or x.dtype
    w = dequantize(qt, dtype)
    xd = x.to(dtype)
    return xd @ w + adapter_delta(xd, p, s, qt.group_size)


def merge(qt: QuantizedLinear, p: QALoRAParams, s: float) -> QuantizedLinear:
    """Fold the adapter into the quantized layer (Appendix B, Eq. 7).

    Only the zero points change; ``qweight`` and ``scale`` are the same
    tensors (no copy, no re-quantization)."""
    with torch.no_grad():
        delta = (p.a.to(torch.float32) @ p.b.to(torch.float32)) * s
        zero = (qt.zero.to(torch.float32) + delta).to(qt.zero.dtype)
    return QuantizedLinear(qt.qweight, qt.scale, zero, qt.bits, qt.group_size)


def attach(generator: torch.Generator, w: torch.Tensor, bits: int,
           group_size: int, rank: int, dtype=torch.float32, quantizer=None):
    """Quantize a float weight and create its adapter (RTN by default)."""
    qfn = quantizer or (lambda w_: quantize(w_, bits, group_size,
                                            scale_dtype=dtype))
    qt = qfn(w)
    p = init_qalora(generator, qt.n_groups, rank, qt.d_out, dtype,
                    device=w.device)
    return qt, p
