"""Public dequant-matmul entry points over :class:`QuantizedLinear`.

Flattens the leading dims of x and dispatches by M: M <= ``GEMV_MAX_M``
(= 8, decode) goes to the GEMV kernels of :mod:`.qmatvec`, larger M
(prefill) to the tiled kernels of :mod:`.qmatmul` / :mod:`.qalora_fused`.
The kernels mask their own edges, so M is never padded.  Block shapes are
fixed in the kernels (no autotuning).

On CUDA tensors every call launches a kernel or raises; CPU tensors take
the kernels' plain versions.
"""

from __future__ import annotations

import math

from ..core.qalora import QALoRAParams
from ..core.quant import QuantizedLinear
from .qalora_fused import qalora_matmul_cuda
from .qmatmul import qmatmul_cuda
from .qmatvec import GEMV_MAX_M, qalora_matvec_cuda, qmatvec_cuda


def _flatten(x):
    """x ``[..., K]`` -> (contiguous ``[M, K]``, lead, M)."""
    *lead, k = x.shape
    m = int(math.prod(lead)) if lead else 1
    return x.reshape(m, k).contiguous(), lead, m


def qmatmul(x, qt: QuantizedLinear):
    """``y = x @ dequant(qt)``; any leading dims on x."""
    x2, lead, m = _flatten(x)
    fn = qmatvec_cuda if m <= GEMV_MAX_M else qmatmul_cuda
    y = fn(x2, qt.qweight, qt.scale, qt.zero, bits=qt.bits,
           group_size=qt.group_size)
    return y.reshape(*lead, qt.d_out)


def qalora_matmul(x, qt: QuantizedLinear, p: QALoRAParams, s: float = 1.0):
    """Fused ``y = x @ dequant(qt) + s * pool_sum(x) @ A @ B``."""
    x2, lead, m = _flatten(x)
    fn = qalora_matvec_cuda if m <= GEMV_MAX_M else qalora_matmul_cuda
    y = fn(x2, qt.qweight, qt.scale, qt.zero, p.a.detach(), p.b.detach(),
           s=float(s), bits=qt.bits, group_size=qt.group_size)
    return y.reshape(*lead, qt.d_out)
