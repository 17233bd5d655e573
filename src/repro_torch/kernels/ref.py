"""Plain f32 oracles for the kernels (counterpart of
``repro.kernels.ref``)."""

from __future__ import annotations

import torch

from ..core.qalora import QALoRAParams, adapter_delta
from ..core.quant import QuantizedLinear, dequantize


def qmatmul_ref(x, qt: QuantizedLinear, out_dtype=None):
    """y = x @ dequant(W_q), computed in f32."""
    w = dequantize(qt, torch.float32)
    y = x.to(torch.float32) @ w
    return y.to(out_dtype or x.dtype)


def qalora_matmul_ref(x, qt: QuantizedLinear, p: QALoRAParams, s: float,
                      out_dtype=None):
    """y = x @ dequant(W_q) + s * pool_sum(x) @ A @ B, computed in f32."""
    y = qmatmul_ref(x, qt, torch.float32)
    f32 = QALoRAParams(p.a.detach().to(torch.float32),
                       p.b.detach().to(torch.float32))
    y = y + adapter_delta(x.to(torch.float32), f32, s, qt.group_size)
    return y.to(out_dtype or x.dtype)
