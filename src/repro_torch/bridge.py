"""Load parameters given as nested dicts of numpy arrays into the port's
modules, so the JAX package and the port compute the same thing, and
return the port's parameters (or only its adapters, or any tensors keyed
like them: gradients, moments) in the same layout.

The tree mirrors the reference's ``LM.init`` tree, with layer stacks kept
on their leading axis (the loader slices them into per-layer modules)::

    {"embed": [V, d], "final_ln": {"g": [d]}, "head": <linear>,
     "blocks": {"ln1": {"g": [L, d]}, "ln2": {"g": [L, d]},
                "attn": {"wq": <linear>, "wk": ..., "wv": ..., "wo": ...,
                         "qn": {"g": [L, hd]}, "kn": ...},   # qk-norm only
                "mlp": {"gate": <linear>, "up": ..., "down": ...}}}

and a linear is a dict of tags and arrays (a leading ``[L]`` axis inside
``blocks``)::

    {"scheme": "fp", "weight": [D_in, D_out]}
    {"scheme": "intq", "bits": 4, "group_size": 32,
     "qweight": uint8 [D_in/cpb, D_out], "scale": [L_g, D_out], "zero": ...}
    {"scheme": "qalora", ... as intq ..., "s": 2.0, "a": [L_g, r], "b": [r, D_out]}
    {"scheme": "lora", "weight": [D_in, D_out], "s": 2.0,
     "a": [D_in, r], "b": [r, D_out]}
    {"scheme": "qlora", "codes": uint8 [n, block/2], "absmax": [n],
     "shape": (D_in, D_out), "block": 64, "s": 2.0, "a": ..., "b": ...}

The head is a linear of any of these schemes (a quantized one under an
explicit ``lm_head`` policy rule).

The reverse direction (:func:`numpy_tree`, :func:`adapters_numpy`) stacks
per-layer tensors back on a leading ``[L]`` axis; bf16 tensors come back
as f32 (exact), since numpy has no bf16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schemes
from repro_torch.core.lora import LoRAParams
from repro_torch.core.nf4 import NF4Tensor
from repro_torch.core.qalora import QALoRAParams
from repro_torch.core.quant import QuantizedLinear
from repro_torch.models.common import RMSNorm
from repro_torch.models.lm import LMParams, resolve_device


def _tensor(a, device, layer=None):
    a = np.asarray(a)
    if layer is not None:
        a = a[layer]
    return torch.from_numpy(np.array(a)).to(device)


def _norm(d, device, layer=None) -> RMSNorm:
    return RMSNorm(_tensor(d["g"], device, layer))


def _linear(d, cfg: ArchConfig, path: str, device, layer=None):
    scheme = d["scheme"]
    pol = schemes.resolve_path(cfg.quant, path)
    if scheme == "fp":
        w = _tensor(d["weight"], device, layer)
        return schemes.dense_linear(w, dataclasses.replace(pol, dtype=w.dtype))
    if scheme in ("lora", "qlora"):
        ad = LoRAParams(_tensor(d["a"], device, layer),
                        _tensor(d["b"], device, layer))
        pol = dataclasses.replace(pol, mode=scheme, s=float(d["s"]),
                                  rank=ad.a.shape[1], dtype=ad.a.dtype)
        if scheme == "lora":
            base = {"w": _tensor(d["weight"], device, layer)}
        else:
            base = {"nf4": NF4Tensor(_tensor(d["codes"], device, layer),
                                     _tensor(d["absmax"], device, layer),
                                     tuple(d["shape"]), int(d["block"]))}
        return schemes.LinearParams({**base, "ad": ad}, scheme=scheme,
                                    policy=pol)
    if scheme not in ("intq", "qalora"):
        raise NotImplementedError(f"{path}: scheme {scheme!r} is not yet "
                                  f"ported (see ROADMAP.md)")
    qt = QuantizedLinear(_tensor(d["qweight"], device, layer),
                         _tensor(d["scale"], device, layer),
                         _tensor(d["zero"], device, layer),
                         int(d["bits"]), int(d["group_size"]))
    pol = dataclasses.replace(pol, mode=scheme, bits=qt.bits,
                              group_size=qt.group_size,
                              scale_dtype=qt.scale.dtype)
    data = {"q": qt}
    if scheme == "qalora":
        ad = QALoRAParams(_tensor(d["a"], device, layer),
                          _tensor(d["b"], device, layer))
        pol = dataclasses.replace(pol, s=float(d["s"]), rank=ad.a.shape[1],
                                  dtype=ad.a.dtype)
        data["ad"] = ad
    return schemes.LinearParams(data, scheme=scheme, policy=pol)


def _block(tree, cfg: ArchConfig, device, layer: int) -> nn.ModuleDict:
    attn_t, mlp_t = tree["attn"], tree["mlp"]
    attn = nn.ModuleDict({
        name: _linear(attn_t[name], cfg, f"blocks/attn/{name}", device, layer)
        for name in ("wq", "wk", "wv", "wo")})
    for name in ("qn", "kn"):
        if name in attn_t:
            attn[name] = _norm(attn_t[name], device, layer)
    mlp = nn.ModuleDict({
        name: _linear(mlp_t[name], cfg, f"blocks/mlp/{name}", device, layer)
        for name in ("gate", "up", "down") if name in mlp_t})
    return nn.ModuleDict({"ln1": _norm(tree["ln1"], device, layer),
                          "ln2": _norm(tree["ln2"], device, layer),
                          "attn": attn, "mlp": mlp})


def load_numpy_tree(tree, cfg: ArchConfig, device="cuda") -> LMParams:
    """Build :class:`LMParams` for ``cfg`` from a numpy tree (layout in the
    module docstring), on ``device``."""
    dev = resolve_device(device)
    head = None
    if not cfg.tie_embeddings:
        head = _linear(tree["head"], cfg, "lm_head", dev)
    blocks = [_block(tree["blocks"], cfg, dev, layer)
              for layer in range(cfg.n_layers)]
    return LMParams(_tensor(tree["embed"], dev), _norm(tree["final_ln"], dev),
                    head, blocks)


# ---------------------------------------------------------------------------
# the reverse direction: the port's tensors as the numpy layout
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _nest(flat: Dict[tuple, dict]):
    """``{path: {layer or None: array or scalar}}`` -> the nested layout,
    layers stacked on a leading axis (a per-layer scalar must agree
    across layers)."""
    out: dict = {}
    for path, by_layer in flat.items():
        if None in by_layer:
            leaf = by_layer[None]
        else:
            vals = [by_layer[i] for i in sorted(by_layer)]
            if isinstance(vals[0], np.ndarray):
                leaf = np.stack(vals)
            elif any(v != vals[0] for v in vals):
                raise ValueError(f"{'/'.join(path)} differs across layers: "
                                 f"{vals}")
            else:
                leaf = vals[0]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _where(name: str):
    """A module name's layout path and layer (``blocks.3.attn.wq`` ->
    (("blocks", "attn", "wq"), 3))."""
    parts = tuple(name.split("."))
    if parts[0] == "blocks":
        return ("blocks",) + parts[2:], int(parts[1])
    return parts, None


def adapters_numpy(params: LMParams,
                   values: Optional[Dict[str, torch.Tensor]] = None):
    """The adapters of ``params`` as the numpy layout: ``{"blocks":
    {"attn": {"wq": {"a": [L, L_g, r], "b": [L, r, D_out]}, ...}, "mlp":
    {...}}}``.  With ``values`` (tensors keyed like
    :func:`repro_torch.core.schemes.trainable_tensors`: gradients, AdamW
    moments), those tensors are laid out in the adapters' places."""
    values = values if values is not None else \
        schemes.trainable_tensors(params)
    flat: Dict[tuple, dict] = {}
    for mname, lp in params.named_modules():
        if not schemes.is_linear(lp):
            continue
        path, layer = _where(mname)
        for pname, _ in lp.named_parameters():
            key = path + (pname.rsplit(".", 1)[-1],)
            flat.setdefault(key, {})[layer] = _np(values[f"{mname}.{pname}"])
    return _nest(flat)


def linear_numpy(lp: schemes.LinearParams) -> dict:
    """One tagged linear in the numpy layout of the module docstring."""
    if lp.scheme == "fp":
        return {"scheme": "fp", "weight": _np(schemes.dense_view(lp))}
    if lp.scheme not in ("lora", "qlora", "intq", "qalora"):
        raise NotImplementedError(f"scheme {lp.scheme!r} has no numpy "
                                  f"layout")
    out = {"scheme": lp.scheme}
    base = schemes.frozen_base(lp)
    if lp.scheme == "lora":
        out["weight"] = _np(base)
    elif lp.scheme == "qlora":
        out.update(codes=_np(base.codes), absmax=_np(base.absmax),
                   shape=base.shape, block=base.block)
    else:
        out.update(bits=base.bits, group_size=base.group_size,
                   qweight=_np(base.qweight), scale=_np(base.scale),
                   zero=_np(base.zero))
    if lp.scheme != "intq":
        ad = schemes.adapter_params(lp)
        out.update(s=lp.policy.s, a=_np(ad.a), b=_np(ad.b))
    return out


def numpy_tree(params: LMParams):
    """The whole of ``params`` in the layout :func:`load_numpy_tree`
    reads (the reference's ``LM.init`` tree, layers stacked)."""
    flat: Dict[tuple, dict] = {}

    def put(path, layer, **leaves):
        for k, v in leaves.items():
            flat.setdefault(path + (k,), {})[layer] = v

    for mname, mod in params.named_modules():
        if isinstance(mod, RMSNorm):
            put(*_where(mname), g=_np(mod.g))
        elif schemes.is_linear(mod):
            put(*_where(mname), **linear_numpy(mod))
    tree = _nest(flat)
    tree["embed"] = _np(params.embed)
    return tree
