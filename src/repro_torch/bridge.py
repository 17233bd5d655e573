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

where a gqa_moe block has ``"moe"`` in place of ``"mlp"``,

    "moe": {"router": <linear>,                      # fp, exempt
            "gate": <linear>, "up": ..., "down": ...,  # experts: [L, E, ...]
            "bias": [L, E],                          # sigmoid routing only
            "shared": {"gate": ..., "up": ..., "down": ...}}  # shared experts

and an mla_moe model has, in place of ``blocks``, ``dense_blocks`` (an
``"mlp"`` each) and ``moe_blocks`` (an ``"moe"`` each), whose ``"attn"``
is MLA's ``{"q_down", "q_up", "kv_down", "kv_up", "wo": <linear>, "qn",
"kvn": {"g"}}``, and with an MTP head ``"mtp_proj"`` (an exempt fp
linear), ``"mtp_block"`` (one dense MLA block, no layer axis) and
``"mtp_ln"``.  An rwkv block is ``{"ln1", "ln2", "mix"}``, ``mix`` holding
the linears ``wr wk wv wg wo ck cv cr`` and the fp arrays ``mu [L, 5, d]``,
``w0``, ``w1``, ``w2``, ``u``, ``cmu`` and ``ln_x``; a mamba_hybrid model
has ``mamba_groups`` (Mamba2 mixers stacked ``[G, P]``: ``in_proj``,
``out_proj``, ``norm`` and the fp arrays ``conv_w``, ``conv_b``,
``dt_bias``, ``a_log``, ``d_skip``), ``mamba_tail`` (stacked ``[T]``) and
``shared_attn`` (one gqa block, no layer axis); an encdec model has
``enc_blocks`` (gqa blocks with the MLP, stacked ``[L_enc]``),
``dec_blocks`` (each also with ``"ln3"`` and a ``"cross"`` attention of
the gqa linears, stacked ``[L]``) and ``enc_ln``.  A linear is a dict of
tags and arrays (a leading ``[L]`` axis inside
``blocks``, ``[L, E]`` for an expert stack)::

    {"scheme": "fp", "weight": [D_in, D_out]}     # + "exempt": True (router)
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
per-layer (and per-expert) tensors back on leading ``[L]`` (``[L, E]``)
axes; bf16 tensors come back as f32 (exact), since numpy has no bf16.
:func:`load_adapters` reads adapters of that layout (a reference run's)
back into a model's trainable tensors.
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
from repro_torch.models.moe import MoEParams
from repro_torch.models.slot_state import hybrid_layout
from repro_torch.models.ssm import Mamba2Params, RWKV6Params


def _tensor(a, device, layer=None):
    """``a`` (at index ``layer``: a layer, or a (layer, expert) pair) as a
    tensor on ``device``."""
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
        lp = schemes.dense_linear(w, dataclasses.replace(pol, dtype=w.dtype))
        lp.exempt = bool(d.get("exempt", False))
        return lp
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


def _mlp(tree, cfg: ArchConfig, path: str, device, layer) -> nn.ModuleDict:
    return nn.ModuleDict({
        name: _linear(tree[name], cfg, f"{path}/{name}", device, layer)
        for name in ("gate", "up", "down") if name in tree})


def _moe(tree, cfg: ArchConfig, device, layer: int,
         path: str = "blocks/moe") -> MoEParams:
    experts = {name: [_linear(tree[name], cfg, f"{path}/{name}", device,
                              (layer, e)) for e in range(cfg.n_experts)]
               for name in ("gate", "up", "down")}
    return MoEParams(
        _linear(tree["router"], cfg, f"{path}/router", device, layer),
        experts["gate"], experts["up"], experts["down"],
        _tensor(tree["bias"], device, layer) if "bias" in tree else None,
        _mlp(tree["shared"], cfg, f"{path}/shared", device, layer)
        if "shared" in tree else None)


# an attention's linears and norms, in the order the port's init makes them
_ATTN = {"gqa": (("wq", "wk", "wv", "wo"), ("qn", "kn")),
         "mla": (("q_down", "q_up", "kv_down", "kv_up", "wo"), ("qn", "kvn"))}


def _fp(tree, names, device, layer) -> dict:
    return {name: _tensor(tree[name], device, layer) for name in names}


def _rwkv_mix(tree, cfg: ArchConfig, device, layer) -> RWKV6Params:
    path = "blocks/mix"
    return RWKV6Params(
        {name: _linear(tree[name], cfg, f"{path}/{name}", device, layer)
         for name in RWKV6Params.LINEARS},
        _norm(tree["ln_x"], device, layer),
        **_fp(tree, ("mu", "w0", "w1", "w2", "u", "cmu"), device, layer))


def _mamba(tree, cfg: ArchConfig, path: str, device, layer) -> Mamba2Params:
    return Mamba2Params(
        _linear(tree["in_proj"], cfg, f"{path}/in_proj", device, layer),
        _linear(tree["out_proj"], cfg, f"{path}/out_proj", device, layer),
        _norm(tree["norm"], device, layer),
        **_fp(tree, ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip"),
              device, layer))


def _block(tree, cfg: ArchConfig, device, layer, path="blocks") \
        -> nn.ModuleDict:
    """Block ``layer`` of the stack at ``path`` (layer None: an unstacked
    block, the MTP head's and the shared attention block's)."""
    if "mix" in tree:
        return nn.ModuleDict({"ln1": _norm(tree["ln1"], device, layer),
                              "ln2": _norm(tree["ln2"], device, layer),
                              "mix": _rwkv_mix(tree["mix"], cfg, device,
                                               layer)})
    attn_t = tree["attn"]
    linears, norms = _ATTN["mla" if "kv_up" in attn_t else "gqa"]
    attn = nn.ModuleDict({
        name: _linear(attn_t[name], cfg, f"{path}/attn/{name}", device, layer)
        for name in linears})
    for name in norms:
        if name in attn_t:
            attn[name] = _norm(attn_t[name], device, layer)
    out = nn.ModuleDict({"ln1": _norm(tree["ln1"], device, layer),
                         "ln2": _norm(tree["ln2"], device, layer),
                         "attn": attn})
    if "cross" in tree:  # an encdec decoder block
        out["ln3"] = _norm(tree["ln3"], device, layer)
        out["cross"] = nn.ModuleDict({
            name: _linear(tree["cross"][name], cfg, f"{path}/cross/{name}",
                          device, layer) for name in _ATTN["gqa"][0]})
    if "moe" in tree:
        out["moe"] = _moe(tree["moe"], cfg, device, layer, f"{path}/moe")
    else:
        out["mlp"] = _mlp(tree["mlp"], cfg, f"{path}/mlp", device, layer)
    return out


def _n_layers(stack) -> int:
    """Layers of a stacked block tree (its first norm's leading axis)."""
    return int(np.shape(stack["ln1"]["g"])[0])


def _mla_parts(tree, cfg: ArchConfig, device) -> dict:
    out = {name: [_block(tree[name], cfg, device, layer, name)
                  for layer in range(_n_layers(tree[name]))]
           for name in ("dense_blocks", "moe_blocks")}
    if "mtp_block" in tree:
        out["mtp_proj"] = _linear(tree["mtp_proj"], cfg, "mtp_proj", device)
        out["mtp_block"] = _block(tree["mtp_block"], cfg, device, None,
                                  "mtp_block")
        out["mtp_ln"] = _norm(tree["mtp_ln"], device)
    return out


def _hybrid_parts(tree, cfg: ArchConfig, device) -> dict:
    groups = tree["mamba_groups"]
    ng, per = np.shape(groups["norm"]["g"])[:2]
    return {"mamba_groups": [[_mamba(groups, cfg, "mamba_groups", device,
                                     (g, j)) for j in range(per)]
                             for g in range(ng)],
            "mamba_tail": [_mamba(tree["mamba_tail"], cfg, "mamba_tail",
                                  device, j)
                           for j in range(hybrid_layout(cfg)[2])],
            "shared_attn": _block(tree["shared_attn"], cfg, device, None,
                                  "shared_attn")}


def _encdec_parts(tree, cfg: ArchConfig, device) -> dict:
    return {name: [_block(tree[name], cfg, device, layer, name)
                   for layer in range(_n_layers(tree[name]))]
            for name in ("enc_blocks", "dec_blocks")} | {
        "enc_ln": _norm(tree["enc_ln"], device)}


def load_numpy_tree(tree, cfg: ArchConfig, device="cuda") -> LMParams:
    """Build :class:`LMParams` for ``cfg`` from a numpy tree (layout in the
    module docstring), on ``device``."""
    dev = resolve_device(device)
    head = None
    if not cfg.tie_embeddings:
        head = _linear(tree["head"], cfg, "lm_head", dev)
    if cfg.family == "mla_moe":
        return LMParams(_tensor(tree["embed"], dev),
                        _norm(tree["final_ln"], dev), head, [],
                        parts=_mla_parts(tree, cfg, dev))
    if cfg.family == "mamba_hybrid":
        return LMParams(_tensor(tree["embed"], dev),
                        _norm(tree["final_ln"], dev), head, [],
                        parts=_hybrid_parts(tree, cfg, dev))
    if cfg.family == "encdec":
        return LMParams(_tensor(tree["embed"], dev),
                        _norm(tree["final_ln"], dev), head, [],
                        parts=_encdec_parts(tree, cfg, dev))
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


def _stack(path, by_index: dict):
    """``{index tuple: array or scalar}`` -> one leaf, stacked on a leading
    axis per index position (a scalar must agree across indices)."""
    if () in by_index:
        return by_index[()]
    groups: dict = {}
    for ix, v in by_index.items():
        groups.setdefault(ix[0], {})[ix[1:]] = v
    vals = [_stack(path, groups[i]) for i in sorted(groups)]
    if isinstance(vals[0], np.ndarray):
        return np.stack(vals)
    if any(v != vals[0] for v in vals):
        raise ValueError(f"{'/'.join(path)} differs across layers or "
                         f"experts: {vals}")
    return vals[0]


def _nest(flat: Dict[tuple, dict]):
    """``{path: {index tuple: array or scalar}}`` -> the nested layout,
    layers (and experts) stacked on leading axes."""
    out: dict = {}
    for path, by_index in flat.items():
        leaf = _stack(path, by_index)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _where(name: str):
    """A module name's layout path and index: its layer, and its expert
    for an expert linear (``blocks.3.attn.wq`` -> (("blocks", "attn",
    "wq"), (3,)), ``blocks.3.moe.up.5`` -> (("blocks", "moe", "up"),
    (3, 5)), ``head`` -> (("head",), ()))."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


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
        path, index = _where(mname)
        for pname, _ in lp.named_parameters():
            key = path + (pname.rsplit(".", 1)[-1],)
            flat.setdefault(key, {})[index] = _np(values[f"{mname}.{pname}"])
    return _nest(flat)


@torch.no_grad()
def load_adapters(params: LMParams, adapters) -> LMParams:
    """Copy adapters given in the :func:`adapters_numpy` layout (e.g. a
    reference run's trained ones, layers and experts stacked on leading
    axes) into ``params``' trainable tensors, in place, each cast to its
    tensor's dtype.  Every adapter of ``params`` must be in the tree, at
    its tensor's shape.  Returns ``params``."""
    for mname, lp in params.named_modules():
        if not schemes.is_linear(lp):
            continue
        path, index = _where(mname)
        for pname, t in lp.named_parameters():
            node = adapters
            for k in path + (pname.rsplit(".", 1)[-1],):
                node = node[k]
            a = np.asarray(node)[index]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{mname}.{pname}: adapter "
                                 f"{tuple(a.shape)}, model {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)).to(t.device, t.dtype))
    return params


def linear_numpy(lp: schemes.LinearParams) -> dict:
    """One tagged linear in the numpy layout of the module docstring."""
    if lp.scheme == "fp":
        return {"scheme": "fp", "weight": _np(schemes.dense_view(lp)),
                **({"exempt": True} if lp.exempt else {})}
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

    def put(path, index, **leaves):
        for k, v in leaves.items():
            flat.setdefault(path + (k,), {})[index] = v

    for mname, mod in params.named_modules():
        if isinstance(mod, RMSNorm):
            put(*_where(mname), g=_np(mod.g))
        elif schemes.is_linear(mod):
            put(*_where(mname), **linear_numpy(mod))
        elif isinstance(mod, MoEParams) and mod.bias is not None:
            put(*_where(mname), bias=_np(mod.bias))
        elif isinstance(mod, (Mamba2Params, RWKV6Params)):
            put(*_where(mname), **{k: _np(t) for k, t in
                                   mod.named_buffers(recurse=False)})
    tree = _nest(flat)
    tree["embed"] = _np(params.embed)
    return tree
