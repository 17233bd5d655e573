"""Tiled dequant matmul ``y = x @ dequant(W_q)`` for M > 8 (prefill).

Replaces ``qmatmul_pallas`` (``src/repro/kernels/qmatmul.py:76``) with the
CUDA kernel in ``csrc/qmatmul.cu`` + ``csrc/tiled.cuh``.  Bound by
operations at prefill M; the kernel runs 128 x 64 output tiles on the
tensor cores (WMMA bf16, f32 accumulators) over a 4-stage ``cp.async``
ring of raw operands, with each dequantised weight tile shared by 128
rows of x.

:func:`qmatmul_cuda` launches the kernel for CUDA tensors (and raises on
anything it does not take) and runs :func:`qmatmul_plain`, the plain
PyTorch version with the kernel's cast points, for CPU tensors (and its
shapes alone for ``meta`` ones: a dry run).
"""

from __future__ import annotations

import math

import torch

from ..core.quant import codes_per_byte, unpack
from . import build
from .build import PLAIN_DEVICES

SCALE_DTYPES = (torch.bfloat16, torch.float32)
# Above this M the tiled kernels run; at or below it the GEMV kernels (and
# the rank projection's one-row-a-block launch).
GEMV_MAX_M = 8


def dequant_plain(qweight, scale, zero, bits: int, group_size: int, dtype):
    """``w = code * scale + zero`` in f32, cast to ``dtype`` (the kernels'
    shared dequant core; ``_dequant_block`` in the JAX package)."""
    codes = unpack(qweight, bits).to(torch.float32)
    k, n = codes.shape
    grouped = codes.reshape(k // group_size, group_size, n)
    w = (grouped * scale.to(torch.float32)[:, None, :]
         + zero.to(torch.float32)[:, None, :])
    return w.reshape(k, n).to(dtype)


def qmatmul_plain(x, qweight, scale, zero, *, bits: int, group_size: int):
    """Plain version: dequant to ``x.dtype``, product accumulated in f32,
    output in ``x.dtype``."""
    w = dequant_plain(qweight, scale, zero, bits, group_size, x.dtype)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


def check_operands(x, qweight, scale, zero, bits: int, group_size: int):
    """Raise on what the CUDA kernels do not take; returns (m, k, n)."""
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"bits must be 2, 3, 4 or 8, got {bits}")
    tensors = {"x": x, "qweight": qweight, "scale": scale, "zero": zero}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16 on CUDA, got {x.dtype}")
    if qweight.dtype != torch.uint8:
        raise TypeError(f"qweight must be uint8, got {qweight.dtype}")
    if scale.dtype not in SCALE_DTYPES or zero.dtype != scale.dtype:
        raise TypeError(f"scale/zero must share a dtype in {SCALE_DTYPES}, "
                        f"got {scale.dtype}/{zero.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    cpb = codes_per_byte(bits)
    n = qweight.shape[1]
    if k % group_size or group_size % cpb:
        raise ValueError(f"K={k} must be a multiple of group_size="
                         f"{group_size}, itself a multiple of {cpb}")
    if tuple(qweight.shape) != (k // cpb, n):
        raise ValueError(f"qweight must be {(k // cpb, n)}, got "
                         f"{tuple(qweight.shape)}")
    for name, t in (("scale", scale), ("zero", zero)):
        if tuple(t.shape) != (k // group_size, n):
            raise ValueError(f"{name} must be {(k // group_size, n)}, got "
                             f"{tuple(t.shape)}")
    return m, k, n


def block_k(group_size: int) -> int:
    """K step of the tiled kernels: a multiple of the group size and of 16
    (the WMMA depth), at least 64 (fewer, larger steps: each step costs
    one barrier and one ring stage)."""
    step = group_size * 16 // math.gcd(group_size, 16)
    bk = step * -(-64 // step)
    if bk > 128:
        raise ValueError(f"group_size={group_size} gives a K step of {bk}; "
                         f"the tiled kernels take at most 128")
    return bk


def qmatmul_cuda(x, qweight, scale, zero, *, bits: int, group_size: int):
    """``y = x @ dequant(W_q)``; x ``[M, K]`` bf16 on CUDA (any M, meant for
    M > 8), or any float dtype on the CPU (plain version)."""
    if x.device.type in PLAIN_DEVICES:
        return qmatmul_plain(x, qweight, scale, zero, bits=bits,
                             group_size=group_size)
    m, k, n = check_operands(x, qweight, scale, zero, bits, group_size)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library("qmatmul").qmatmul_bf16(
        x.data_ptr(), qweight.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        y.data_ptr(), m, k, n, group_size, block_k(group_size), bits,
        int(scale.dtype == torch.float32), build.current_stream(x.device))
    build.check(rc, "qmatmul_bf16")
    qmatmul_cuda.launches += 1
    return y


qmatmul_cuda.launches = 0
