"""Public dequant-matmul entry points over :class:`QuantizedLinear`.

Flattens the leading dims of x and dispatches by M: M <= ``GEMV_MAX_M``
(= 8, decode) goes to the GEMV kernels of :mod:`.qmatvec`, larger M
(prefill) to the tiled kernels of :mod:`.qmatmul` / :mod:`.qalora_fused`.
The kernels mask their own edges, so M is never padded.  Block shapes are
fixed in the kernels (no autotuning).

On CUDA tensors every call launches a kernel or raises; CPU tensors take
the kernels' plain versions.  :func:`qalora_slot_matmul` at M > 8 adds the
plain PyTorch bank delta to the tiled base product, as the reference does
outside any Pallas kernel.

:func:`qalora_matmul` is differentiable in x, A and B (the Pallas kernels
have no VJP, so the backward is plain PyTorch); the quantized base gets no
gradient.  The other entry points serve only.
"""

from __future__ import annotations

import math

import torch

from ..core.qalora import QALoRAParams, bank_adapter_delta
from ..core.quant import QuantizedLinear
from .flash import flash_mha_cuda
from .qalora_fused import qalora_matmul_cuda
from .qmatmul import dequant_plain, qmatmul_cuda
from .qmatvec import (GEMV_MAX_M, qalora_matvec_cuda,
                      qalora_slot_matvec_cuda, qmatvec_cuda)


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


class _QALoRAMatmul(torch.autograd.Function):
    """The fused product of :func:`qalora_matmul` on ``x [M, K]``.  Forward:
    the GEMV kernel at M <= 8 and the tiled one above on CUDA, the plain
    version on the CPU.  Backward, in plain PyTorch with ``t = pool_g(x) @
    A`` and the forward's cast points (f32 sums, each gradient in its
    input's dtype)::

        dB = s * t^T dY
        dA = s * pool_g(x)^T (dY B^T)
        dx = dY dequant(W)^T + s * expand_g(dY B^T A^T)
    """

    @staticmethod
    def forward(ctx, x, a, b, qt, s):
        fn = qalora_matvec_cuda if x.shape[0] <= GEMV_MAX_M \
            else qalora_matmul_cuda
        ctx.save_for_backward(x, a, b)
        ctx.qt, ctx.s = qt, s
        return fn(x, qt.qweight, qt.scale, qt.zero, a, b, s=s, bits=qt.bits,
                  group_size=qt.group_size)

    @staticmethod
    def backward(ctx, dy):
        x, a, b = ctx.saved_tensors
        qt, s = ctx.qt, ctx.s
        f32, g = torch.float32, qt.group_size
        m, k = x.shape
        dyf = dy.to(f32)
        pooled = x.to(f32).reshape(m, k // g, g).sum(-1).to(x.dtype).to(f32)
        dyb = dyf @ b.to(f32).T                                 # [M, r]
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            w = dequant_plain(qt.qweight, qt.scale, qt.zero, qt.bits, g,
                              x.dtype).to(f32)
            dpool = dyb @ a.to(x.dtype).to(f32).T               # [M, L]
            dx = (dyf @ w.T + s * dpool.repeat_interleave(g, dim=1)) \
                .to(x.dtype)
        if ctx.needs_input_grad[1]:
            da = (s * (pooled.T @ dyb)).to(a.dtype)
        if ctx.needs_input_grad[2]:
            t = (pooled @ a.to(x.dtype).to(f32)).to(b.dtype).to(f32)
            db = (s * (t.T @ dyf)).to(b.dtype)
        return dx, da, db, None, None


def qalora_matmul(x, qt: QuantizedLinear, p: QALoRAParams, s: float = 1.0):
    """Fused ``y = x @ dequant(qt) + s * pool_sum(x) @ A @ B``; gradients
    reach x, ``p.a`` and ``p.b`` (:class:`_QALoRAMatmul`)."""
    x2, lead, m = _flatten(x)
    y = _QALoRAMatmul.apply(x2, p.a, p.b, qt, float(s))
    return y.reshape(*lead, qt.d_out)


def _slot_matmul_tiled(x, qweight, scale, zero, a_bank, b_bank, ids, *,
                       s: float, bits: int, group_size: int):
    """M > 8: the tiled base kernel plus the plain bank delta, rounded to
    x's dtype before the sum, as in the reference."""
    base = qmatmul_cuda(x, qweight, scale, zero, bits=bits,
                        group_size=group_size)
    delta = bank_adapter_delta(x, a_bank, b_bank, ids, s, group_size)
    return base + delta.to(base.dtype)


def qalora_slot_matmul(x, qt: QuantizedLinear, a_bank, b_bank, ids,
                       s: float = 1.0):
    """Multi-tenant ``y[i] = x[i] @ dequant(qt) + s * pool(x[i]) @
    A[ids[i]] @ B[ids[i]]`` over banks ``a_bank [N, L, r]`` / ``b_bank
    [N, r, D_out]``; ``ids`` has shape ``x.shape[:-1]`` (one bank row per
    leading row of x).  M <= 8 (decode) runs the slot GEMV kernel in one
    launch; larger M the tiled base kernel plus
    :func:`repro_torch.core.qalora.bank_adapter_delta`."""
    if tuple(ids.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"ids must have shape x.shape[:-1] = "
                         f"{tuple(x.shape[:-1])}, got {tuple(ids.shape)}")
    x2, lead, m = _flatten(x)
    fn = qalora_slot_matvec_cuda if m <= GEMV_MAX_M else _slot_matmul_tiled
    y = fn(x2, qt.qweight, qt.scale, qt.zero, a_bank, b_bank,
           ids.reshape(m).contiguous(), s=float(s), bits=qt.bits,
           group_size=qt.group_size)
    return y.reshape(*lead, qt.d_out)


def flash_mha(q, k, v, causal=True, window=0, block_q=128, block_k=128):
    """Flash attention, q/k/v ``[B, S, H, d]`` (MHA: a GQA caller expands
    K/V to q's heads first), output ``[B, Sq, H, d]`` in q's dtype; the
    counterpart of ``repro.kernels.ops.flash_mha``.  Heads fold into the
    batch for :func:`~repro_torch.kernels.flash.flash_mha_cuda`, which
    checks the rest.  The block sizes (capped at Sq and Sk) must divide the
    sequences, as the Pallas kernel requires; they shape only the plain
    version's tiles."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, d], got "
                             f"{tuple(t.shape)}")
    b, sq, h, _ = q.shape
    if k.shape[2] != h or v.shape[2] != h:
        raise ValueError(f"flash_mha is MHA only: k and v need q's {h} heads "
                         f"(expand GQA K/V first), got {k.shape[2]} and "
                         f"{v.shape[2]}")

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], t.shape[3]) \
            .contiguous()
    # through a name, as the dispatch above: repro_lint's RL004 follows
    # calls by simple name from the reference's jit root `flash_mha`
    fn = flash_mha_cuda
    o = fn(fold(q), fold(k), fold(v), causal=causal, window=window,
           block_q=block_q, block_k=block_k)
    return o.reshape(b, h, sq, o.shape[-1]).permute(0, 2, 1, 3)
