"""Decode-shape dequant GEMV for M <= ``GEMV_MAX_M`` rows of x.

Replaces ``qmatvec_pallas`` and ``qalora_matvec_pallas``
(``src/repro/kernels/qmatvec.py:68`` and ``:133``) with the CUDA kernels in
``csrc/qmatvec.cu``.  Bound by bytes: at M <= 8 the packed-code stream is
the whole cost.  One thread per output column reads its column's packed
bytes down K (coalesced across the warp in the ``[K/cpb, N]`` layout),
reads each group's scale and zero once, and keeps M f32 accumulators in
registers.  K is split across the blocks of a thread-block cluster and
across each block's warps; the partial sums are added in shared memory
and then, in a fixed order, across the cluster through distributed
shared memory.  Each block stages its K-slice of x in shared memory.

The wrappers launch the kernels for CUDA tensors (and raise on anything
they do not take) and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .qalora_fused import check_adapter, qalora_matmul_plain
from .qmatmul import check_operands, qmatmul_plain

# Above this M the tiled kernels run; at or below it the GEMV kernels.
GEMV_MAX_M = 8


def qmatvec_plain(x, qweight, scale, zero, *, bits: int, group_size: int):
    """Plain version: the same product and cast points as
    :func:`repro_torch.kernels.qmatmul.qmatmul_plain`."""
    return qmatmul_plain(x, qweight, scale, zero, bits=bits,
                         group_size=group_size)


def qalora_matvec_plain(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                        group_size: int):
    """Plain version: the cast points of ``qmatvec.py:112-130``, which are
    those of :func:`repro_torch.kernels.qalora_fused.qalora_matmul_plain`."""
    return qalora_matmul_plain(x, qweight, scale, zero, a, b, s=s, bits=bits,
                               group_size=group_size)


def _check_gemv(x, qweight, scale, zero, bits, group_size):
    m, k, n = check_operands(x, qweight, scale, zero, bits, group_size)
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"the GEMV kernels take 1 <= M <= {GEMV_MAX_M}, "
                         f"got M={m}")
    if group_size % 4:
        raise ValueError(f"the GEMV kernels take group sizes that are "
                         f"multiples of 4, got {group_size}")
    return m, k, n


def qmatvec_cuda(x, qweight, scale, zero, *, bits: int, group_size: int):
    """``y = x @ dequant(W_q)`` for x ``[M <= 8, K]`` bf16 on CUDA, or any
    float dtype on the CPU (plain version)."""
    if x.device.type == "cpu":
        return qmatvec_plain(x, qweight, scale, zero, bits=bits,
                             group_size=group_size)
    m, k, n = _check_gemv(x, qweight, scale, zero, bits, group_size)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qmatvec").qmatvec_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        y.data_ptr(), m, k, n, group_size, bits,
        int(scale.dtype == torch.float32), build.current_stream(x.device))
    build.check(rc, "qmatvec_bf16")
    qmatvec_cuda.launches += 1
    return y


qmatvec_cuda.launches = 0


def qalora_matvec_cuda(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                       group_size: int):
    """Fused QA-LoRA product for x ``[M <= 8, K]`` bf16 on CUDA, or any
    float dtype on the CPU (plain version)."""
    if x.device.type == "cpu":
        return qalora_matvec_plain(x, qweight, scale, zero, a, b, s=s,
                                   bits=bits, group_size=group_size)
    m, k, n = _check_gemv(x, qweight, scale, zero, bits, group_size)
    rank = check_adapter(x, a, b, k, n, group_size)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qmatvec").qalora_matvec_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        a.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n, group_size, rank,
        float(s), bits, int(scale.dtype == torch.float32),
        build.current_stream(x.device))
    build.check(rc, "qalora_matvec_bf16")
    qalora_matvec_cuda.launches += 1
    return y


qalora_matvec_cuda.launches = 0
