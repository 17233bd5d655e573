"""Group-wise asymmetric min-max quantization (INT2/3/4/8) with bit packing.

PyTorch counterpart of ``repro.core.quant``, with the same storage layout:
``W`` is ``[D_in, D_out]`` and used as ``y = x @ W``; groups partition the
input dimension into ``L = D_in // group_size`` groups, and each
``(group, column)`` owns one ``scale`` and one ``zero``:

    q       = round((w - zero) / scale)            in {0, ..., 2^bits - 1}
    dequant = scale * q + zero

``zero`` is the group minimum stored as a float, which is what makes the
QA-LoRA merge exact: the merge rewrites ``zero`` only.

Packed storage: INT4 packs 2 codes per byte and INT2 packs 4 along axis 0
(code t of byte row r sits at logical row ``r * cpb + t``); INT3 and INT8
store one code per byte.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["QuantizedLinear", "quantize", "dequantize", "pack", "unpack",
           "codes_per_byte", "packed_rows", "quantization_error"]


def codes_per_byte(bits: int) -> int:
    """How many quantized codes fit in one storage byte."""
    return {2: 4, 3: 1, 4: 2, 8: 1}[bits]


def packed_rows(d_in: int, bits: int) -> int:
    cpb = codes_per_byte(bits)
    assert d_in % cpb == 0, (d_in, bits)
    return d_in // cpb


class QuantizedLinear(nn.Module):
    """A frozen, quantized linear layer's storage.

    Buffers: ``qweight`` uint8 ``[D_in / codes_per_byte(bits), D_out]``,
    ``scale`` / ``zero`` ``[L, D_out]``.  ``bits`` and ``group_size`` are
    plain ints.
    """

    def __init__(self, qweight: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, bits: int, group_size: int):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.bits = int(bits)
        self.group_size = int(group_size)

    @property
    def d_in(self) -> int:
        return self.qweight.shape[0] * codes_per_byte(self.bits)

    @property
    def d_out(self) -> int:
        return self.qweight.shape[1]

    @property
    def n_groups(self) -> int:
        return self.scale.shape[0]


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes (values < 2**bits) along axis 0 into uint8."""
    q = q.to(torch.uint8)
    cpb = codes_per_byte(bits)
    if cpb == 1:
        return q
    d_in = q.shape[0]
    assert d_in % cpb == 0, (d_in, bits)
    q = q.reshape((d_in // cpb, cpb) + tuple(q.shape[1:]))
    out = q[:, 0].clone()
    for k in range(1, cpb):
        out |= q[:, k] << (bits * k)
    return out


def unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack`; returns uint8 codes along axis 0."""
    cpb = codes_per_byte(bits)
    if cpb == 1:
        return packed
    mask = 2**bits - 1
    parts = [(packed >> (bits * k)) & mask for k in range(cpb)]
    stacked = torch.stack(parts, dim=1)  # [rows, cpb, ...]
    return stacked.reshape((packed.shape[0] * cpb,) + tuple(packed.shape[1:]))


def quantize(w: torch.Tensor, bits: int, group_size: int,
             scale_dtype: torch.dtype = torch.float32) -> QuantizedLinear:
    """Group-wise asymmetric min-max (RTN) quantization of ``w [D_in, D_out]``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    d_in, d_out = w.shape
    assert d_in % group_size == 0, (d_in, group_size)
    n_groups = d_in // group_size
    levels = 2**bits - 1

    wg = w.to(torch.float32).reshape(n_groups, group_size, d_out)
    w_min = wg.amin(dim=1)  # [L, D_out]
    w_max = wg.amax(dim=1)
    # the reference writes `/ levels`, which XLA compiles into a multiply
    # by the f32 reciprocal of the constant; multiplying here keeps the
    # scales bit-identical (a true division differs in the last bit)
    inv_levels = torch.tensor(1.0 / levels, dtype=torch.float32,
                              device=w.device)
    scale = (w_max - w_min) * inv_levels
    # guard degenerate all-equal groups
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = w_min

    q = torch.round((wg - zero[:, None, :]) / scale[:, None, :])
    q = q.clamp(0, levels).to(torch.uint8).reshape(d_in, d_out)
    return QuantizedLinear(pack(q, bits), scale.to(scale_dtype),
                           zero.to(scale_dtype), bits, group_size)


def dequantize(qt: QuantizedLinear, dtype: torch.dtype = torch.float32):
    """Reconstruct the float weight ``[D_in, D_out]``."""
    q = unpack(qt.qweight, qt.bits).to(torch.float32)
    d_in, d_out = q.shape
    q = q.reshape(qt.n_groups, qt.group_size, d_out)
    w = (q * qt.scale.to(torch.float32)[:, None, :]
         + qt.zero.to(torch.float32)[:, None, :])
    return w.reshape(d_in, d_out).to(dtype)


def quantization_error(w: torch.Tensor, bits: int, group_size: int):
    """Mean squared RTN quantization error of ``w`` (in f32)."""
    qt = quantize(w, bits, group_size)
    return torch.mean((dequantize(qt) - w.to(torch.float32)) ** 2)
