"""NF4 (4-bit NormalFloat) quantization, the QLoRA baseline's datatype
(PyTorch counterpart of ``repro.core.nf4``).

The 16-level NF4 codebook of Dettmers et al. 2023 with block-wise absmax
scaling (block = 64 by default).  Used only as the accuracy baseline
(QLoRA, and QLoRA + PTQ): it has no kernel, and its forward dequantizes
the whole weight, which is the inefficiency QA-LoRA removes.

Codes and absmax are bit-identical to the reference's: absmax and the
normalised weights are computed in f32, and the nearest code is the first
index of the smallest distance (``torch.argmin`` breaks ties to the first
index, as ``jnp.argmin`` does).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["NF4_CODE", "NF4Tensor", "nf4_quantize", "nf4_dequantize"]

# Exact NF4 code values (QLoRA paper, Appendix E / bitsandbytes).
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

# elements of the [rows, block, 16] distance tensor materialised at a time
# (128 MB of f32): a 4096 x 11008 weight at once would take 2.9 GB
_CHUNK_ELEMENTS = 1 << 21


class NF4Tensor(nn.Module):
    """Buffers ``codes`` uint8 ``[n, block / 2]`` (two codes a byte, the
    even element in the low nibble) and ``absmax`` f32 ``[n]``, over the
    weight's flat blocks; ``shape`` and ``block`` are plain values."""

    def __init__(self, codes: torch.Tensor, absmax: torch.Tensor,
                 shape: Tuple[int, ...], block: int):
        super().__init__()
        self.register_buffer("codes", codes)
        self.register_buffer("absmax", absmax)
        self.shape = tuple(int(s) for s in shape)
        self.block = int(block)


def _code(device) -> torch.Tensor:
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


@torch.no_grad()
def nf4_quantize(w: torch.Tensor, block: int = 64) -> NF4Tensor:
    """Block-wise absmax NF4 quantization of ``w`` (any shape whose size is
    a multiple of ``block``), on ``w``'s device."""
    shape = tuple(w.shape)
    flat = w.detach().to(torch.float32).reshape(-1)
    assert flat.shape[0] % block == 0, (shape, block)
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    absmax = torch.where(absmax <= 0, torch.ones_like(absmax), absmax)
    code = _code(w.device)
    idx = torch.empty(blocks.shape, dtype=torch.uint8, device=w.device)
    rows = max(1, _CHUNK_ELEMENTS // (block * code.numel()))
    for r in range(0, blocks.shape[0], rows):
        normed = blocks[r:r + rows] / absmax[r:r + rows, None]  # in [-1, 1]
        dist = (normed[..., None] - code).abs()
        idx[r:r + rows] = dist.argmin(dim=-1).to(torch.uint8)
    packed = idx[:, 0::2] | (idx[:, 1::2] << 4)
    return NF4Tensor(packed, absmax, shape, block)


def nf4_dequantize(t: NF4Tensor, dtype: torch.dtype = torch.float32):
    """The weight of ``t`` in ``dtype`` (f32 products, then the cast)."""
    codes = t.codes
    idx = torch.stack([codes & 0xF, codes >> 4], dim=-1).reshape(
        codes.shape[:-1] + (-1,))
    vals = _code(codes.device)[idx.to(torch.int64)] * t.absmax[..., None]
    return vals.reshape(t.shape).to(dtype)
