"""Load parameters given as nested dicts of numpy arrays into the port's
modules, so the JAX package and the port compute the same thing.

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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schemes
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
