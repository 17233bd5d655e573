"""GPTQ (Frantar et al., ICLR 2023), the Hessian-guided one-shot quantizer
the paper puts under its base (Sec. 4.1: group size 32, ``act_order``
off, asymmetric).  PyTorch counterpart of ``repro.core.gptq``.

Convention of :mod:`.quant`: ``W [D_in, D_out]``, groups along ``D_in``.
GPTQ walks the input features in index order; each feature's rounding
error, divided by the diagonal of the upper Cholesky factor ``U`` of
``H^{-1}``, is pushed onto the features not yet quantized along row ``i``
of ``U``, and each group's scale and zero are refitted at its first
feature on the error-compensated rows.  The output is a
:class:`~.quant.QuantizedLinear`, so kernels 1-4 take it unchanged.

The work runs in float64 on the weight's device.  It takes the lazy-batch
form of the GPTQ paper: inside a block of ``block`` features (a multiple
of the group size, so every group lies in one block and is refitted on
fully updated rows) each feature's error updates the block's later rows
at once, and the block's errors update every later row by one product at
the block's end.  That is the reference's arithmetic up to the order of
the f64 sums.  The D_out columns are independent of each other.

On CUDA the recursion inside a block (a few elementwise ops a feature,
over all columns) is captured once per block shape as a CUDA graph
(:class:`repro_torch.runtime.graphs.StepGraphs`) and replayed for every
block: run op by op, the host's launch rate would bound it.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from .quant import QuantizedLinear, pack

__all__ = ["hessian_from_inputs", "gptq_quantize",
           "gptq_quantize_from_calibration", "release_graphs"]

BLOCK = 128


def hessian_from_inputs(x) -> torch.Tensor:
    """``H = 2 X^T X`` in f64 from calibration activations
    ``x [n_samples, D_in]``, on ``x``'s device."""
    x = torch.as_tensor(x).to(torch.float64)
    return 2.0 * (x.T @ x)


def _block(w, u, q, err, scale, zero, *, group_size: int, levels: int):
    """The recursion over one block of rows, in place.  ``w [b, D_out]``:
    the block's rows, updated by every earlier block; ``u [b, b]``: U's
    diagonal block.  Writes the codes (as f64) to ``q``, the scaled
    errors to ``err`` and each group's scale and zero."""
    for i in range(w.shape[0]):
        g = i // group_size
        s, z = scale[g], zero[g]
        if i % group_size == 0:
            # refit scale / zero on the error-compensated group
            grp = w[i:i + group_size]
            torch.amin(grp, dim=0, out=z)
            torch.sub(torch.amax(grp, dim=0), z, out=s)
            s.div_(levels).masked_fill_(s <= 0, 1.0)
        wi = w[i]
        torch.round((wi - z) / s, out=q[i])
        q[i].clamp_(0, levels)
        torch.sub(wi, s * q[i] + z, out=err[i])
        err[i].div_(u[i, i])
        if i + 1 < w.shape[0]:
            w[i + 1:].sub_(torch.outer(u[i, i + 1:], err[i]))


# one runner per (device, block rows, D_out, group size, levels): static
# buffers and, on CUDA, the captured graph of _block on them
_RUNNERS: Dict[Tuple, Tuple] = {}


def _runner(device, rows: int, d_out: int, group_size: int, levels: int):
    # imported here: runtime.graphs imports the kernels, which import core
    from repro_torch.runtime.graphs import StepGraphs
    key = (str(device), rows, d_out, group_size, levels)
    hit = _RUNNERS.get(key)
    if hit is None:
        def buf(*shape):
            return torch.empty(shape, dtype=torch.float64, device=device)
        bufs = {"w": buf(rows, d_out), "u": buf(rows, rows),
                "q": buf(rows, d_out), "err": buf(rows, d_out),
                "scale": buf(rows // group_size, d_out),
                "zero": buf(rows // group_size, d_out)}
        fn = functools.partial(_block, **bufs, group_size=group_size,
                               levels=levels)
        graphs = StepGraphs("gptq.block", device)
        hit = _RUNNERS[key] = (bufs, functools.partial(graphs, key, fn))
    return hit


def release_graphs() -> None:
    """Drop the captured block graphs and their buffers."""
    _RUNNERS.clear()


@torch.no_grad()
def gptq_quantize(w, hessian, bits: int, group_size: int,
                  percdamp: float = 0.01, scale_dtype=torch.float32,
                  block: int = BLOCK) -> QuantizedLinear:
    """Quantize ``w [D_in, D_out]`` given the input Hessian
    ``[D_in, D_in]``, on ``w``'s device.  ``block`` is rounded down to a
    multiple of the group size (at least one group); a block of D_in rows
    or more is the reference's unblocked recursion."""
    dev = w.device
    w = w.detach().to(torch.float64, copy=True)
    h = torch.as_tensor(hessian).to(dev, torch.float64, copy=True)
    d_in, d_out = w.shape
    assert d_in % group_size == 0, (d_in, group_size)
    levels = 2**bits - 1

    # dead input features: no signal, so pin the weight to 0 (it rounds
    # freely)
    dead = torch.diagonal(h) == 0
    h[dead, dead] = 1.0
    w[dead, :] = 0.0
    damp = percdamp * torch.mean(torch.diagonal(h))
    torch.diagonal(h).add_(damp)
    # upper Cholesky factor of H^-1: H^-1 = U^T U
    u = torch.linalg.cholesky(torch.linalg.inv(h)).T.contiguous()
    del h

    codes = torch.empty((d_in, d_out), dtype=torch.uint8, device=dev)
    scales = torch.empty((d_in // group_size, d_out), dtype=torch.float64,
                         device=dev)
    zeros = torch.empty_like(scales)
    rows = group_size * max(1, block // group_size)
    for i1 in range(0, d_in, rows):
        i2 = min(i1 + rows, d_in)
        bufs, run = _runner(dev, i2 - i1, d_out, group_size, levels)
        bufs["w"].copy_(w[i1:i2])
        bufs["u"].copy_(u[i1:i2, i1:i2])
        run()
        codes[i1:i2] = bufs["q"]
        g1, g2 = i1 // group_size, i2 // group_size
        scales[g1:g2] = bufs["scale"]
        zeros[g1:g2] = bufs["zero"]
        if i2 < d_in:
            w[i2:].addmm_(u[i1:i2, i2:].T, bufs["err"], alpha=-1)
    return QuantizedLinear(pack(codes, bits), scales.to(scale_dtype),
                           zeros.to(scale_dtype), bits, group_size)


def gptq_quantize_from_calibration(w, x_calib, bits: int, group_size: int,
                                   **kw) -> QuantizedLinear:
    return gptq_quantize(w, hessian_from_inputs(x_calib), bits, group_size,
                         **kw)
