"""Decode-shape dequant GEMV for M <= ``GEMV_MAX_M`` rows of x.

Replaces ``qmatvec_pallas``, ``qalora_matvec_pallas`` and
``qalora_slot_matvec_pallas`` (``src/repro/kernels/qmatvec.py:68``, ``:133``
and ``:212``) with the CUDA kernels in ``csrc/qmatvec.cu``.  Bound by
bytes: at M <= 8 the packed-code stream is the whole cost, so the kernel
dequantises on the CUDA cores straight into ``mma.sync`` fragments and
leaves the products to the tensor cores (x padded to 8 rows), with K
split across the warps of a block and the blocks of a cluster and the
partial sums added in a fixed order.  The adapter and slot kernels take
``t = bf16(pool_g(x) @ A)`` from the rank projection of
``csrc/rank_proj.cuh`` (``A[ids[i]]`` per row for the slot kernel), which
the same host call launches first into a ``[M, r]`` scratch; the GEMV is
launched as its programmatic dependent and adds ``s * t @ B`` in its
epilogue (``B[ids[i]]`` per row; rows of the null adapter skip it).  The
C entry reports which of its two kernels it launched, and the wrappers
count from that.

The wrappers launch the kernels for CUDA tensors (and raise on anything
they do not take) and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .qalora_fused import (MAX_RANK, check_adapter, qalora_matmul_plain,
                           qalora_rank_proj_cuda)
from .qmatmul import GEMV_MAX_M, check_operands, dequant_plain, qmatmul_plain

# Set by the two-launch C entries: whether they launched the projection
# ([0]) and the GEMV ([1]).
_LAUNCHED = (ctypes.c_int * 2)()
_LAUNCHED_PTR = ctypes.addressof(_LAUNCHED)


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


def qalora_slot_rank_proj_plain(x, a_bank, ids, *, group_size: int,
                                out_dtype=None):
    """Plain slot projection ``t[i] = pool_sum_g(x[i]) @ A[ids[i]]`` with
    the cast points of :func:`~repro_torch.kernels.qalora_fused.
    qalora_rank_proj_plain`: pooled x summed in f32 and cast to
    ``x.dtype``, A cast to ``x.dtype``, the product summed in f32 and cast
    to ``out_dtype`` (default ``x.dtype``).  Rows of the null adapter (bank
    row 0, zeros) give zeros."""
    f32 = torch.float32
    m, k = x.shape
    pooled = x.to(f32).reshape(m, k // group_size, group_size).sum(-1)
    t = torch.einsum("ml,mlr->mr", pooled.to(x.dtype).to(f32),
                     a_bank[ids.to(torch.int64)].to(x.dtype).to(f32))
    return t.to(out_dtype or x.dtype)


def qalora_slot_matvec_plain(x, qweight, scale, zero, a_bank, b_bank, ids, *,
                             s: float, bits: int, group_size: int):
    """Plain version of the slot kernel: the cast points of
    :func:`qalora_matvec_plain` (``qmatvec.py:173-209`` in the reference),
    with row i's A and B gathered from bank row ``ids[i]``.  A row of the
    null adapter (zeros) gets exactly the base product."""
    f32 = torch.float32
    w = dequant_plain(qweight, scale, zero, bits, group_size, x.dtype)
    acc = x.to(f32) @ w.to(f32)
    t = qalora_slot_rank_proj_plain(x, a_bank, ids, group_size=group_size,
                                    out_dtype=b_bank.dtype)
    adapter = torch.einsum("mr,mrn->mn", t.to(f32),
                           b_bank[ids.to(torch.int64)].to(f32))
    return (acc + s * adapter).to(x.dtype)


def _check_gemv(x, qweight, scale, zero, bits, group_size):
    m, k, n = check_operands(x, qweight, scale, zero, bits, group_size)
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"the GEMV kernels take 1 <= M <= {GEMV_MAX_M}, "
                         f"got M={m}")
    if group_size % 4:
        raise ValueError(f"the GEMV kernels take group sizes that are "
                         f"multiples of 4, got {group_size}")
    return m, k, n


def _out_and_scratch(x, m: int, n: int, rank: int):
    """y ``[m, n]`` and the address of the projection's scratch t
    ``[m, r]`` (bf16), from one allocation and one view: t 16-byte aligned
    after y.  The host runs this for every adapter linear of a decode
    step, so it makes no tensor for t."""
    off = (m * n + 7) // 8 * 8
    buf = torch.empty(off + m * rank, dtype=torch.bfloat16, device=x.device)
    return buf.as_strided((m, n), (n, 1)), buf.data_ptr() + 2 * off


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
    float dtype on the CPU (plain version).  One host call, two launches
    on the current stream: the rank projection (kernel 3's, one row of x a
    block; counted by :func:`qalora_rank_proj_cuda`) into a ``[M, r]``
    bf16 scratch carved from y's allocation, then the GEMV (counted
    here)."""
    if x.device.type == "cpu":
        return qalora_matvec_plain(x, qweight, scale, zero, a, b, s=s,
                                   bits=bits, group_size=group_size)
    m, k, n = _check_gemv(x, qweight, scale, zero, bits, group_size)
    rank = check_adapter(x, a, b, k, n, group_size)
    y, t = _out_and_scratch(x, m, n, rank)
    rc = build.library("qmatvec").qalora_matvec_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        a.data_ptr(), b.data_ptr(), t, y.data_ptr(), m, k, n,
        group_size, rank, float(s), bits, int(scale.dtype == torch.float32),
        _LAUNCHED_PTR, build.current_stream(x.device))
    qalora_rank_proj_cuda.launches += _LAUNCHED[0]
    qalora_matvec_cuda.launches += _LAUNCHED[1]
    build.check(rc, "qalora_matvec_bf16")
    return y


qalora_matvec_cuda.launches = 0


def check_bank(x, a_bank, b_bank, ids, m: int, k: int, n: int,
               group_size: int):
    """Raise on adapter banks or ids the slot kernels do not take (``b_bank``
    None: the projection alone); returns (rank, bank rows).  The ids'
    values are checked where they are made (``AdapterStore.with_slot_ids``),
    not here: reading them would copy from the card on every launch.  The
    kernels trap on one outside the bank."""
    banks = (("a_bank", a_bank),) + ((("b_bank", b_bank),)
                                     if b_bank is not None else ())
    for name, t in banks + (("ids", ids),):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t.dtype != torch.bfloat16 for _, t in banks):
        raise TypeError(f"the banks must be bfloat16 on CUDA, got "
                        f"{[str(t.dtype) for _, t in banks]}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (m,):
        raise ValueError(f"ids must be int32 of shape {(m,)}, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if any(t.dim() != 3 for _, t in banks):
        raise ValueError(f"banks must be [N, L, r] and [N, r, D_out], got "
                         f"{[tuple(t.shape) for _, t in banks]}")
    n_ad, _, rank = a_bank.shape
    if (tuple(a_bank.shape) != (n_ad, k // group_size, rank)
            or (b_bank is not None
                and tuple(b_bank.shape) != (n_ad, rank, n))):
        raise ValueError(f"banks must be {(n_ad, k // group_size, rank)} and "
                         f"{(n_ad, rank, n)}, got "
                         f"{[tuple(t.shape) for _, t in banks]}")
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"rank must be in [1, {MAX_RANK}], got {rank}")
    return rank, n_ad


def qalora_slot_rank_proj_cuda(x, a_bank, ids, *, group_size: int):
    """Slot projection ``t[i] = bf16(pool_sum_g(x[i]) @ A[ids[i]])``,
    ``[M, r]``; x ``[M <= 8, K]`` and the bank ``[N, K / g, r]`` bf16, ids
    ``[M]`` int32, on CUDA, or any float dtype on the CPU (plain version).
    Kernel 5's first launch, on its own."""
    if x.device.type == "cpu":
        return qalora_slot_rank_proj_plain(x, a_bank, ids,
                                           group_size=group_size)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 [M, K] on CUDA, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    m, k = x.shape
    if not 1 <= m <= GEMV_MAX_M or k % group_size:
        raise ValueError(f"the slot projection takes 1 <= M <= {GEMV_MAX_M} "
                         f"and K % g == 0, got M={m}, K={k}, g={group_size}")
    rank, n_ad = check_bank(x, a_bank, None, ids, m, k, 0, group_size)
    t = torch.empty((m, rank), dtype=torch.bfloat16, device=x.device)
    rc = build.library("qmatvec").qalora_slot_rank_proj_bf16(
        x.data_ptr(), a_bank.data_ptr(), ids.data_ptr(), t.data_ptr(), m, k,
        group_size, rank, n_ad, build.current_stream(x.device))
    build.check(rc, "qalora_slot_rank_proj_bf16")
    qalora_slot_rank_proj_cuda.launches += 1
    return t


qalora_slot_rank_proj_cuda.launches = 0


def qalora_slot_matvec_cuda(x, qweight, scale, zero, a_bank, b_bank, ids, *,
                            s: float, bits: int, group_size: int):
    """Multi-tenant fused QA-LoRA product, one adapter per row: x
    ``[M <= 8, K]`` bf16, banks ``[N, L, r]`` / ``[N, r, D_out]`` bf16 and
    ``ids [M]`` int32, all on CUDA; or any float dtype on the CPU (plain
    version).  One host call, two launches: the slot projection (counted by
    :func:`qalora_slot_rank_proj_cuda`), then the GEMV (counted here)."""
    if x.device.type == "cpu":
        return qalora_slot_matvec_plain(x, qweight, scale, zero, a_bank,
                                        b_bank, ids, s=s, bits=bits,
                                        group_size=group_size)
    m, k, n = _check_gemv(x, qweight, scale, zero, bits, group_size)
    rank, n_ad = check_bank(x, a_bank, b_bank, ids, m, k, n, group_size)
    y, t = _out_and_scratch(x, m, n, rank)
    rc = build.library("qmatvec").qalora_slot_matvec_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        a_bank.data_ptr(), b_bank.data_ptr(), ids.data_ptr(), t,
        y.data_ptr(), m, k, n, group_size, rank, n_ad, float(s), bits,
        int(scale.dtype == torch.float32), _LAUNCHED_PTR,
        build.current_stream(x.device))
    qalora_slot_rank_proj_cuda.launches += _LAUNCHED[0]
    qalora_slot_matvec_cuda.launches += _LAUNCHED[1]
    build.check(rc, "qalora_slot_matvec_bf16")
    return y


qalora_slot_matvec_cuda.launches = 0
