"""Fused QA-LoRA matmul ``y = x @ dequant(W_q) + s * pool_g(x) @ A @ B``
for M > 8.

Replaces ``qalora_matmul_pallas`` (``src/repro/kernels/qalora_fused.py:62``)
with the CUDA kernel in ``csrc/qalora_fused.cu`` + ``csrc/tiled.cuh``.
Bound by operations at prefill M, like :mod:`.qmatmul`; the adapter
rides inside the same K loop on the x tile already in shared memory
(pooling and the ``[64, r]`` rank accumulation), and ``@ B`` runs once
per output tile, so x is read once.

:func:`qalora_matmul_cuda` launches the kernel for CUDA tensors and runs
:func:`qalora_matmul_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .qmatmul import block_k, check_operands, dequant_plain

MAX_RANK = 128  # the GEMV kernels' shared-memory adapter accumulator


def qalora_matmul_plain(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                        group_size: int):
    """Plain version with the kernels' cast points: pooled x summed in f32
    and cast to ``x.dtype``; ``A`` cast to ``x.dtype``; the rank
    accumulator cast to ``B.dtype`` before ``@ B``; every product
    accumulated in f32; ``acc + s * adapter`` cast to ``x.dtype``."""
    w = dequant_plain(qweight, scale, zero, bits, group_size, x.dtype)
    f32 = torch.float32
    acc = x.to(f32) @ w.to(f32)
    m, k = x.shape
    pooled = x.to(f32).reshape(m, k // group_size, group_size).sum(-1)
    lacc = pooled.to(x.dtype).to(f32) @ a.to(x.dtype).to(f32)
    adapter = lacc.to(b.dtype).to(f32) @ b.to(f32)
    return (acc + s * adapter).to(x.dtype)


def check_adapter(x, a, b, k: int, n: int, group_size: int) -> int:
    """Raise on an adapter the CUDA kernels do not take; returns the rank."""
    for name, t in (("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"A/B must be bfloat16 on CUDA, got "
                        f"{a.dtype}/{b.dtype}")
    rank = a.shape[1]
    if tuple(a.shape) != (k // group_size, rank) or tuple(b.shape) != (rank, n):
        raise ValueError(f"A must be {(k // group_size, rank)} and B "
                         f"{(rank, n)}, got {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"rank must be in [1, {MAX_RANK}], got {rank}")
    return rank


def qalora_matmul_cuda(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                       group_size: int):
    """Fused QA-LoRA product; x ``[M, K]`` bf16 on CUDA (meant for M > 8),
    or any float dtype on the CPU (plain version)."""
    if x.device.type == "cpu":
        return qalora_matmul_plain(x, qweight, scale, zero, a, b, s=s,
                                   bits=bits, group_size=group_size)
    m, k, n = check_operands(x, qweight, scale, zero, bits, group_size)
    rank = check_adapter(x, a, b, k, n, group_size)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qalora_fused").qalora_matmul_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        a.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n, group_size, rank,
        block_k(group_size), float(s), bits,
        int(scale.dtype == torch.float32), build.current_stream(x.device))
    build.check(rc, "qalora_matmul_bf16")
    qalora_matmul_cuda.launches += 1
    return y


qalora_matmul_cuda.launches = 0
