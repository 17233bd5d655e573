"""Decode-shape dequant GEMV for M <= ``GEMV_MAX_M`` rows of x.

Replaces ``qmatvec_pallas``, ``qalora_matvec_pallas`` and
``qalora_slot_matvec_pallas`` (``src/repro/kernels/qmatvec.py:68``, ``:133``
and ``:212``) with the CUDA kernels in ``csrc/qmatvec.cu``.  Bound by
bytes: at M <= 8 the packed-code stream is the whole cost.  One thread
per output column reads its column's packed bytes down K (coalesced
across the warp in the ``[K/cpb, N]`` layout), reads each group's scale
and zero once, and keeps M f32 accumulators in registers.  K is split across the blocks of a thread-block cluster and
across each block's warps; the partial sums are added in shared memory
and then, in a fixed order, across the cluster through distributed
shared memory.  Each block stages its K-slice of x in shared memory.
The slot kernel (multi-tenant decode) is the adapter kernel with row i's
A and B taken from bank row ``ids[i]``.

The wrappers launch the kernels for CUDA tensors (and raise on anything
they do not take) and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build
from .qalora_fused import MAX_RANK, check_adapter, qalora_matmul_plain
from .qmatmul import check_operands, dequant_plain, qmatmul_plain

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


def qalora_slot_matvec_plain(x, qweight, scale, zero, a_bank, b_bank, ids, *,
                             s: float, bits: int, group_size: int):
    """Plain version of the slot kernel: the cast points of
    :func:`qalora_matvec_plain` (``qmatvec.py:173-209`` in the reference),
    with row i's A and B gathered from bank row ``ids[i]``.  A row of the
    null adapter (zeros) gets exactly the base product."""
    f32 = torch.float32
    w = dequant_plain(qweight, scale, zero, bits, group_size, x.dtype)
    acc = x.to(f32) @ w.to(f32)
    m, k = x.shape
    pooled = x.to(f32).reshape(m, k // group_size, group_size).sum(-1)
    rows = ids.to(torch.int64)
    lacc = torch.einsum("ml,mlr->mr", pooled.to(x.dtype).to(f32),
                        a_bank[rows].to(x.dtype).to(f32))
    adapter = torch.einsum("mr,mrn->mn", lacc.to(b_bank.dtype).to(f32),
                           b_bank[rows].to(f32))
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


def check_bank(x, a_bank, b_bank, ids, m: int, k: int, n: int,
               group_size: int):
    """Raise on adapter banks or ids the slot kernel does not take; returns
    (rank, bank rows).  The ids' values are checked where they are made
    (``AdapterStore.with_slot_ids``), not here: reading them would copy
    from the card on every launch.  The kernel traps on one outside the
    bank."""
    for name, t in (("a_bank", a_bank), ("b_bank", b_bank), ("ids", ids)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_bank.dtype != torch.bfloat16 or b_bank.dtype != torch.bfloat16:
        raise TypeError(f"the banks must be bfloat16 on CUDA, got "
                        f"{a_bank.dtype}/{b_bank.dtype}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (m,):
        raise ValueError(f"ids must be int32 of shape {(m,)}, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if a_bank.dim() != 3 or b_bank.dim() != 3:
        raise ValueError(f"banks must be [N, L, r] and [N, r, D_out], got "
                         f"{tuple(a_bank.shape)} / {tuple(b_bank.shape)}")
    n_ad, _, rank = a_bank.shape
    if (tuple(a_bank.shape) != (n_ad, k // group_size, rank)
            or tuple(b_bank.shape) != (n_ad, rank, n)):
        raise ValueError(f"banks must be {(n_ad, k // group_size, rank)} and "
                         f"{(n_ad, rank, n)}, got {tuple(a_bank.shape)} / "
                         f"{tuple(b_bank.shape)}")
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"rank must be in [1, {MAX_RANK}], got {rank}")
    return rank, n_ad


def qalora_slot_matvec_cuda(x, qweight, scale, zero, a_bank, b_bank, ids, *,
                            s: float, bits: int, group_size: int):
    """Multi-tenant fused QA-LoRA product, one adapter per row: x
    ``[M <= 8, K]`` bf16, banks ``[N, L, r]`` / ``[N, r, D_out]`` bf16 and
    ``ids [M]`` int32, all on CUDA; or any float dtype on the CPU (plain
    version)."""
    if x.device.type == "cpu":
        return qalora_slot_matvec_plain(x, qweight, scale, zero, a_bank,
                                        b_bank, ids, s=s, bits=bits,
                                        group_size=group_size)
    m, k, n = _check_gemv(x, qweight, scale, zero, bits, group_size)
    rank, n_ad = check_bank(x, a_bank, b_bank, ids, m, k, n, group_size)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qmatvec").qalora_slot_matvec_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        a_bank.data_ptr(), b_bank.data_ptr(), ids.data_ptr(), y.data_ptr(),
        m, k, n, group_size, rank, n_ad, float(s), bits,
        int(scale.dtype == torch.float32), build.current_stream(x.device))
    build.check(rc, "qalora_slot_matvec_bf16")
    qalora_slot_matvec_cuda.launches += 1
    return y


qalora_slot_matvec_cuda.launches = 0
