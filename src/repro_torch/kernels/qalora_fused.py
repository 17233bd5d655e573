"""Fused QA-LoRA matmul ``y = x @ dequant(W_q) + s * pool_g(x) @ A @ B``
for M > 8.

Replaces ``qalora_matmul_pallas`` (``src/repro/kernels/qalora_fused.py:62``)
with two CUDA launches from ``csrc/qalora_fused.cu``: the rank projection
``t = bf16(pool_sum_g(x) @ A)`` once per call
(:func:`qalora_rank_proj_cuda`), then the tiled kernel of
``csrc/tiled.cuh``, which adds ``s * t @ B`` in its epilogue.  Bound by
operations at prefill M, like :mod:`.qmatmul`.

:func:`qalora_matmul_cuda` launches both kernels for CUDA tensors and runs
:func:`qalora_matmul_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .qmatmul import block_k, check_operands, dequant_plain

MAX_RANK = 128  # the GEMV kernels stage t [8][128] in shared memory


def qalora_rank_proj_plain(x, a, *, group_size: int, out_dtype=None):
    """Plain rank projection ``t = pool_sum_g(x) @ A`` with the kernel's
    cast points: pooled x summed in f32 and cast to ``x.dtype``; ``A``
    cast to ``x.dtype``; the product accumulated in f32 and cast to
    ``out_dtype`` (default ``x.dtype``; B's dtype in the fused product)."""
    f32 = torch.float32
    m, k = x.shape
    pooled = x.to(f32).reshape(m, k // group_size, group_size).sum(-1)
    t = pooled.to(x.dtype).to(f32) @ a.to(x.dtype).to(f32)
    return t.to(out_dtype or x.dtype)


def qalora_matmul_plain(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                        group_size: int):
    """Plain version with the kernels' cast points: the rank projection
    of :func:`qalora_rank_proj_plain`, cast to ``B.dtype`` before ``@ B``;
    every product accumulated in f32; ``acc + s * adapter`` cast to
    ``x.dtype``."""
    w = dequant_plain(qweight, scale, zero, bits, group_size, x.dtype)
    f32 = torch.float32
    acc = x.to(f32) @ w.to(f32)
    t = qalora_rank_proj_plain(x, a, group_size=group_size, out_dtype=b.dtype)
    adapter = t.to(f32) @ b.to(f32)
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


def _rank_proj_launch(x, a, m: int, k: int, group_size: int, rank: int):
    t = torch.empty((m, rank), dtype=torch.bfloat16, device=x.device)
    rc = build.library("qalora_fused").qalora_rank_proj_bf16(
        x.data_ptr(), a.data_ptr(), t.data_ptr(), m, k, group_size, rank,
        build.current_stream(x.device))
    build.check(rc, "qalora_rank_proj_bf16")
    qalora_rank_proj_cuda.launches += 1
    return t


def qalora_rank_proj_cuda(x, a, *, group_size: int):
    """``t = bf16(pool_sum_g(x) @ A)``, ``[M, r]``; x ``[M, K]`` and A
    ``[K / g, r]`` bf16 on CUDA, or any float dtype on the CPU (plain
    version).  Kernel 3's first launch, on its own."""
    if x.device.type == "cpu":
        return qalora_rank_proj_plain(x, a, group_size=group_size)
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"x and a must be on one CUDA device, got "
                         f"{x.device} / {a.device}")
    if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
        raise TypeError(f"x and A must be bfloat16 on CUDA, got "
                        f"{x.dtype}/{a.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or not a.is_contiguous():
        raise ValueError("x must be a contiguous [M, K] and A contiguous")
    m, k = x.shape
    rank = a.shape[1]
    if k % group_size or tuple(a.shape) != (k // group_size, rank) \
            or not 1 <= rank <= MAX_RANK:
        raise ValueError(f"A must be [K / g, r] = [{k // group_size}, r] "
                         f"with 1 <= r <= {MAX_RANK}, got {tuple(a.shape)}")
    return _rank_proj_launch(x, a, m, k, group_size, rank)


qalora_rank_proj_cuda.launches = 0


def qalora_matmul_cuda(x, qweight, scale, zero, a, b, *, s: float, bits: int,
                       group_size: int):
    """Fused QA-LoRA product; x ``[M, K]`` bf16 on CUDA (meant for M > 8),
    or any float dtype on the CPU (plain version).  Two launches on the
    current stream, neither synchronising: the rank projection into a
    ``[M, r]`` bf16 scratch (counted by :func:`qalora_rank_proj_cuda`),
    then the tiled product (counted here)."""
    if x.device.type == "cpu":
        return qalora_matmul_plain(x, qweight, scale, zero, a, b, s=s,
                                   bits=bits, group_size=group_size)
    m, k, n = check_operands(x, qweight, scale, zero, bits, group_size)
    rank = check_adapter(x, a, b, k, n, group_size)
    t = _rank_proj_launch(x, a, m, k, group_size, rank)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qalora_fused").qalora_matmul_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        t.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n, group_size, rank,
        block_k(group_size), float(s), bits,
        int(scale.dtype == torch.float32), build.current_stream(x.device))
    build.check(rc, "qalora_matmul_bf16")
    qalora_matmul_cuda.launches += 1
    return y


qalora_matmul_cuda.launches = 0
