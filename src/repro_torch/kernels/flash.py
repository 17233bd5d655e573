"""Flash attention forward (causal / sliding window) on ``[B·H, S, d]``.

Replaces ``flash_mha_pallas`` (``src/repro/kernels/flash.py:73``) with the
CUDA kernels in ``csrc/flash.cu``.  Bound by operations at the models'
sequence lengths (4·d flops per visible (query, key) pair).  bf16 at the
served head dims (64, 128, 256) runs ``flash_wgmma``: a producer warp
feeds K and V tiles by TMA through a shared-memory ring, two consumer
warpgroups of 64 query rows run both products on ``wgmma`` and overlap
one's softmax with the other's products.  f32 (on the CUDA cores) and
bf16 at d 16 and 32 run the first port's ``mma.sync`` kernel.  Both keep
the online-softmax state in registers and skip key tiles that no row of
the tile sees.

:func:`flash_mha_cuda` launches a kernel for CUDA tensors (and raises on
anything it does not take), records the design the C entry reported in
``flash_mha_cuda.last_design``, and runs :func:`flash_mha_plain`, the
plain PyTorch version with the Pallas kernel's cast points, for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .build import PLAIN_DEVICES

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
# what ``flash_mha_fwd`` reports it launched: the warp-specialised wgmma
# kernel fed by a TMA ring (bf16 at d >= 64), or the mma.sync kernel of
# the first port (f32, and bf16 at d 16 and 32)
DESIGNS = {0: "mma_sync", 1: "wgmma_tma"}
NEG_INF = -1e30


def check_blocks(sq: int, sk: int, block_q: int, block_k: int):
    """The block sizes capped at Sq and Sk, which they must divide (as the
    Pallas kernel asserts)."""
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"block_q={block_q} must divide Sq={sq} and "
                         f"block_k={block_k} must divide Sk={sk}")
    return block_q, block_k


def flash_mha_plain(q, k, v, *, causal=True, window=0, block_q=128,
                    block_k=128):
    """Plain version of ``flash.py:31-70``, one key tile of ``block_k`` at a
    time: scores in f32 scaled after the dot, masked to -1e30, running max
    / sum / accumulator in f32, p rounded to v's dtype before ``p @ v``,
    output ``acc / max(l, 1e-30)`` in q's dtype; the scale is
    ``1/sqrt(d)``.  Every query tile takes
    the key tile at once (query tiles share no state); ``block_q`` is
    checked as the Pallas kernel checks it."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    _, block_k = check_blocks(sq, sk, block_q, block_k)
    scale = 1.0 / math.sqrt(d)
    window = int(window or 0)
    dev = q.device
    qf = q.to(torch.float32)
    qpos = torch.arange(sq, device=dev)[:, None]
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, v.shape[2]), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = (qf @ kb.to(torch.float32).transpose(1, 2)) * scale
        kpos = k0 + torch.arange(block_k, device=dev)[None, :]
        mask = torch.ones((sq, block_k), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).to(torch.float32) @ vb.to(
            torch.float32)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def check_operands(q, k, v):
    """Raise on what the kernel does not take (on either device); returns
    (bh, sq, sk, d)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B*H, S, d], got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {DTYPES}, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if tuple(k.shape) != (bh, sk, d):
        raise ValueError(f"k must be {(bh, sk, d)}, got {tuple(k.shape)}")
    if tuple(v.shape) != (bh, sk, d):
        raise ValueError(f"v must be {(bh, sk, d)} (q's d), got "
                         f"{tuple(v.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError(f"empty sequence: Sq={sq}, Sk={sk}")
    return bh, sq, sk, d


def flash_mha_cuda(q, k, v, *, causal=True, window=0, block_q=128,
                   block_k=128):
    """Flash attention on q, k, v ``[B·H, S, d]``, bf16 or f32, output in
    q's dtype.  CUDA tensors launch the kernel (the block sizes, checked on
    either device, shape only the plain version's tiles); CPU and ``meta``
    tensors take :func:`flash_mha_plain`."""
    bh, sq, sk, d = check_operands(q, k, v)
    check_blocks(sq, sk, block_q, block_k)
    if q.device.type in PLAIN_DEVICES:
        return flash_mha_plain(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha runs on CUDA or the CPU, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    design = ctypes.c_int(-1)
    rc = build.library("flash").flash_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, sk, d,
        int(causal), int(window or 0), 1.0 / math.sqrt(d),
        int(q.dtype == torch.float32), ctypes.byref(design),
        build.current_stream(q.device))
    build.check(rc, "flash_mha_fwd")
    flash_mha_cuda.launches += 1
    flash_mha_cuda.last_design = DESIGNS[design.value]
    return o


flash_mha_cuda.launches = 0
# the design the last launch ran (a value of DESIGNS), as the C entry
# reported it
flash_mha_cuda.last_design = None
