"""Linear-scheme API: registry + tagged params + per-layer policy.

PyTorch counterpart of ``repro.core.schemes``.  This module is the only
place that knows how a linear layer's parameters are stored; everything
else goes through :func:`linear_init`, :func:`linear_apply`,
:func:`merge_linear` / :func:`merge_tree`, :func:`dense_view` and the
conversion :func:`from_dense_linear` / :func:`convert_tree`.

Schemes (dispatched by the tag on :class:`LinearParams`):

  fp       plain dense weight
  lora     fp base + unconstrained LoRA                    (baseline)
  qlora    NF4 base + unconstrained LoRA                   (baseline)
  qalora   INT-N group-wise base + group-pooled adapter    (the paper)
  intq     bare INT-N group-wise linear (merged QA-LoRA or PTQ output)
  qalora_slot  one INT-N base + a bank of adapters, one per batch row
               (multi-tenant serving; built by ``serving.AdapterStore``)

The qalora / intq schemes have one route: the kernel wrappers behind
:mod:`repro_torch.kernels.ops`, which launch the Hopper kernels on CUDA
tensors (or raise) and run the kernels' plain versions on CPU tensors.
The fp, lora and qlora schemes are plain PyTorch products, as in the
reference (no Pallas kernel computes them).

:class:`PolicyTree` maps glob patterns over parameter paths to
:class:`QuantPolicy` records; the last matching rule wins, and the bare
catch-all ``"*"`` never applies to ``lm_head``.
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from . import lora as lora_lib
from . import nf4 as nf4_lib
from . import qalora as qalora_lib
from . import quant as quant_lib

__all__ = [
    "QuantPolicy", "FP", "PolicyTree", "resolve_path",
    "LinearScheme", "LinearParams", "register_scheme", "get_scheme",
    "is_linear", "dense_linear", "quantized_base", "frozen_base",
    "adapter_params", "from_dense_linear", "linear_init", "linear_apply",
    "merge_linear", "dense_view", "map_linears", "merge_tree",
    "convert_tree", "trainable_tensors", "tree_flops_bytes",
]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-linear quantization/adaptation policy (one resolved record)."""

    mode: str = "qalora"  # a registered scheme name
    bits: int = 4
    group_size: int = 32
    rank: int = 16
    s: float = 2.0
    # the reference's kernel switch, kept in the policy record; the port
    # always takes the kernel wrappers
    use_kernel: bool = False
    dtype: Any = torch.float32  # compute/adapter dtype
    scale_dtype: Any = torch.float32  # scale/zero storage dtype

    def at(self, *names: str) -> "QuantPolicy":
        return self

    def resolve(self) -> "QuantPolicy":
        return self

    @property
    def default(self) -> "QuantPolicy":
        return self


FP = QuantPolicy(mode="fp")
_POLICY_FIELDS = frozenset(f.name for f in dataclasses.fields(QuantPolicy))

# the head is exempt from catch-all quantization rules unless named
_HEAD_PATHS = ("lm_head", "head")
_CATCH_ALL = "*"


def _norm_head(path: str) -> str:
    return "lm_head" if path in _HEAD_PATHS else path


@dataclasses.dataclass(frozen=True)
class PolicyTree:
    """Glob-pattern -> :class:`QuantPolicy` rules with scoped resolution
    (``pol.at("attn").at("wq")``); the LAST matching rule wins."""

    rules: Tuple[Tuple[str, QuantPolicy], ...]
    prefix: str = ""

    def at(self, *names: str) -> "PolicyTree":
        pre = "/".join((self.prefix,) + names) if self.prefix else "/".join(names)
        return dataclasses.replace(self, prefix=pre)

    def resolve(self) -> QuantPolicy:
        path = _norm_head(self.prefix)
        hit = None
        for pat, pol in self.rules:
            if path == "lm_head" and pat == _CATCH_ALL:
                continue  # lm_head exemption: catch-all never quantizes it
            if fnmatch.fnmatchcase(path, _norm_head(pat)):
                hit = pol
        if hit is None:
            return dataclasses.replace(self.default, mode="fp")
        return hit

    @property
    def default(self) -> QuantPolicy:
        for pat, pol in reversed(self.rules):
            if pat == _CATCH_ALL:
                return pol
        return self.rules[-1][1] if self.rules else FP

    def __getattr__(self, name):
        # delegate QuantPolicy field reads (``cfg.quant.dtype``) to the
        # default rule
        if name in _POLICY_FIELDS:
            return getattr(self.default, name)
        raise AttributeError(name)

    @classmethod
    def parse(cls, spec: str, base: Optional[QuantPolicy] = None) -> "PolicyTree":
        """Parse ``"*=int4,*/attn/wo=int8,lm_head=fp"``.  Values: ``fp`` |
        ``lora`` | ``qlora`` | ``int<N>`` (QA-LoRA at N bits) | ``intq<N>``
        (bare quantized), with optional ``:g<M>`` / ``:r<R>`` suffixes."""
        base = base or QuantPolicy()
        rules = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"policy item {item!r}: expected pattern=value")
            pat, val = item.split("=", 1)
            rules.append((pat.strip(), _parse_value(val.strip(), base)))
        return cls(rules=tuple(rules))


def _parse_value(val: str, base: QuantPolicy) -> QuantPolicy:
    tok, *opts = val.split(":")
    kw: Dict[str, Any] = {}
    if tok in ("fp", "lora", "qlora"):
        kw["mode"] = tok
    elif tok.startswith("intq"):
        kw["mode"] = "intq"
        if tok[4:]:
            kw["bits"] = int(tok[4:])
    elif tok.startswith("int"):
        kw["mode"] = "qalora"
        if tok[3:]:
            kw["bits"] = int(tok[3:])
    elif tok == "qalora":
        kw["mode"] = "qalora"
    else:
        raise ValueError(f"unknown policy value {tok!r}")
    for o in opts:
        if o.startswith("g"):
            kw["group_size"] = int(o[1:])
        elif o.startswith("r"):
            kw["rank"] = int(o[1:])
        else:
            raise ValueError(f"unknown policy option {o!r} in {val!r}")
    return dataclasses.replace(base, **kw)


def resolve_path(pol, path: str) -> QuantPolicy:
    """Resolve the policy for an explicit parameter path; a uniform policy
    never quantizes ``lm_head``."""
    if isinstance(pol, PolicyTree):
        return dataclasses.replace(pol, prefix=path).resolve()
    if _norm_head(path) == "lm_head" and pol.mode != "fp":
        return dataclasses.replace(pol, mode="fp")
    return pol


# ---------------------------------------------------------------------------
# tagged container
# ---------------------------------------------------------------------------


class LinearParams(nn.Module):
    """One linear layer's parameters, tagged with its scheme + policy.

    The scheme-defined payload is registered on the module (tensors as
    buffers, containers as submodules); :attr:`data` returns it as a dict
    in the order it was given.  ``exempt`` marks a layer kept fp at init
    that conversion must never quantize.
    """

    def __init__(self, data: Dict[str, Any], scheme: str = "fp",
                 policy: QuantPolicy = FP, exempt: bool = False):
        super().__init__()
        self._keys = tuple(data)
        for k, v in data.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_buffer(k, v)
        self.scheme = scheme
        self.policy = policy
        self.exempt = exempt

    @property
    def data(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._keys}


def is_linear(p) -> bool:
    return isinstance(p, LinearParams)


def dense_linear(w: torch.Tensor, policy: Optional[QuantPolicy] = None):
    """Wrap a dense weight as an fp-scheme linear."""
    pol = policy or dataclasses.replace(FP, dtype=w.dtype)
    return LinearParams({"w": w}, scheme="fp",
                        policy=dataclasses.replace(pol, mode="fp"))


# schemes whose payload carries a packed INT-N base
_QUANT_BASE_SCHEMES = ("intq", "qalora", "qalora_slot")


def quantized_base(lp: LinearParams) -> quant_lib.QuantizedLinear:
    """The packed :class:`QuantizedLinear` base of a quantized-base
    scheme."""
    if not is_linear(lp) or lp.scheme not in _QUANT_BASE_SCHEMES:
        got = lp.scheme if is_linear(lp) else type(lp).__name__
        raise ValueError(f"quantized_base: expected one of "
                         f"{_QUANT_BASE_SCHEMES}, got {got!r}")
    data = lp.data
    return data["q"]


def frozen_base(lp: LinearParams):
    """The frozen base of a linear: the one payload item its scheme does
    not declare trainable (the dense weight of ``fp`` and ``lora``, the
    :class:`~.nf4.NF4Tensor` of ``qlora``, the packed base of ``intq`` and
    ``qalora``)."""
    trainable = get_scheme(lp.scheme).trainable_paths(lp.data)
    keys = [k for k in lp.data if k not in trainable]
    if len(keys) != 1:
        raise ValueError(f"frozen_base: scheme {lp.scheme!r} holds "
                         f"{len(keys)} frozen items {keys}; expected one")
    return lp.data[keys[0]]


def adapter_params(lp: LinearParams):
    """The trainable adapter payload of an adapter-bearing linear, found
    through the scheme's :meth:`LinearScheme.trainable_paths`."""
    keys = get_scheme(lp.scheme).trainable_paths(lp.data)
    if len(keys) != 1:
        raise ValueError(f"adapter_params: scheme {lp.scheme!r} declares "
                         f"{len(keys)} trainable keys {tuple(keys)}; "
                         f"expected exactly one adapter payload")
    data = lp.data
    return data[keys[0]]


# ---------------------------------------------------------------------------
# scheme protocol + registry
# ---------------------------------------------------------------------------


class LinearScheme:
    """Protocol for one linear storage/compute scheme over a 2-D
    ``[D_in, D_out]`` payload dict."""

    name: str = "?"
    trainable: Tuple[str, ...] = ()  # payload keys holding trainable leaves

    def init(self, generator, d_in: int, d_out: int, pol: QuantPolicy,
             device) -> dict:
        raise NotImplementedError

    def trainable_paths(self, data: dict) -> Tuple[str, ...]:
        """Payload keys holding trainable leaves (empty: nothing to
        train or extract)."""
        return self.trainable

    def apply(self, data: dict, x, pol: QuantPolicy):
        raise NotImplementedError

    def merge(self, data: dict, pol: QuantPolicy) -> Tuple[str, dict]:
        """Fold adapters for deployment; returns (scheme_name, data)."""
        raise NotImplementedError

    def dense_view(self, data: dict, pol: QuantPolicy, dtype=None):
        """Effective (adapter-included) dense weight ``[D_in, D_out]``."""
        name, merged = self.merge(data, pol)
        return get_scheme(name).dense_view(merged, pol, dtype)

    def from_dense(self, generator, w, pol: QuantPolicy,
                   quantizer: Optional[Callable] = None) -> dict:
        """This scheme's payload from a dense weight ``w [D_in, D_out]``,
        on ``w``'s device: ``quantizer`` (``w -> QuantizedLinear``, e.g. a
        GPTQ closure) replaces RTN for a quantized base, and adapters are
        drawn from ``generator``."""
        raise NotImplementedError

    def stack_ndim(self, data: dict) -> int:
        """Leading stack dims of the payload (0: one ``[D_in, D_out]``
        linear)."""
        raise NotImplementedError

    def flops_bytes(self, data: dict, pol: QuantPolicy, m: int = 1):
        """(flops, weight bytes read) of one linear of the payload for an
        ``[m, D_in]`` activation, plain ints; read from the trailing dims,
        so a stacked payload gives one member's cost (and a ``meta`` one
        costs nothing to ask)."""
        raise NotImplementedError


_REGISTRY: Dict[str, LinearScheme] = {}


def register_scheme(name: str):
    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_scheme(name: str) -> LinearScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown linear scheme {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")


def _randn_weight(generator, d_in, d_out, device):
    return torch.randn((d_in, d_out), generator=generator, device=device,
                       dtype=torch.float32) / math.sqrt(d_in)


@register_scheme("fp")
class FPScheme(LinearScheme):
    """Plain dense linear."""

    def init(self, generator, d_in, d_out, pol, device):
        return {"w": _randn_weight(generator, d_in, d_out, device).to(pol.dtype)}

    def apply(self, data, x, pol):
        return x @ data["w"].to(x.dtype)

    def merge(self, data, pol):
        return "fp", data

    def dense_view(self, data, pol, dtype=None):
        w = data["w"]
        return w.to(dtype) if dtype is not None else w

    def from_dense(self, generator, w, pol, quantizer=None):
        return {"w": w}

    def stack_ndim(self, data):
        return data["w"].dim() - 2

    def flops_bytes(self, data, pol, m=1):
        w = data["w"]
        k, n = w.shape[-2:]
        return 2 * m * k * n, k * n * w.element_size()


@register_scheme("lora")
class LoRAScheme(LinearScheme):
    """fp base + unconstrained LoRA (Hu et al., 2021)."""

    trainable = ("ad",)

    def init(self, generator, d_in, d_out, pol, device):
        w = _randn_weight(generator, d_in, d_out, device).to(pol.dtype)
        return {"w": w, "ad": lora_lib.init_lora(generator, d_in, pol.rank,
                                                 d_out, pol.dtype, device)}

    def apply(self, data, x, pol):
        return lora_lib.lora_forward(x, data["w"].to(x.dtype), data["ad"],
                                     pol.s)

    def merge(self, data, pol):
        return "fp", {"w": lora_lib.lora_merge(data["w"], data["ad"], pol.s)}

    def from_dense(self, generator, w, pol, quantizer=None):
        d_in, d_out = w.shape
        return {"w": w.to(pol.dtype),
                "ad": lora_lib.init_lora(generator, d_in, pol.rank, d_out,
                                         pol.dtype, w.device)}

    def stack_ndim(self, data):
        return data["w"].dim() - 2

    def flops_bytes(self, data, pol, m=1):
        w, b = data["w"], data["ad"].b
        k, n = w.shape[-2:]
        r = b.shape[-2]
        return (2 * m * k * n + 2 * m * r * (k + n),
                k * n * w.element_size() + r * (k + n) * b.element_size())


@register_scheme("qlora")
class QLoRAScheme(LinearScheme):
    """NF4 base + unconstrained LoRA (Dettmers et al., 2023).  The merge
    falls back to fp, the paper's '4+16' row, because the adapter's delta
    is not constant within a group."""

    trainable = ("ad",)

    def init(self, generator, d_in, d_out, pol, device):
        w = _randn_weight(generator, d_in, d_out, device)
        nf4 = nf4_lib.nf4_quantize(w)
        del w
        return {"nf4": nf4, "ad": lora_lib.init_lora(
            generator, d_in, pol.rank, d_out, pol.dtype, device)}

    def apply(self, data, x, pol):
        return lora_lib.qlora_forward(x, data["nf4"], data["ad"], pol.s)

    def merge(self, data, pol):
        return "fp", {"w": lora_lib.qlora_merge_fp(data["nf4"], data["ad"],
                                                   pol.s)}

    def from_dense(self, generator, w, pol, quantizer=None):
        d_in, d_out = w.shape
        return {"nf4": nf4_lib.nf4_quantize(w.to(torch.float32)),
                "ad": lora_lib.init_lora(generator, d_in, pol.rank, d_out,
                                         pol.dtype, w.device)}

    def stack_ndim(self, data):
        return data["nf4"].codes.dim() - 2

    def flops_bytes(self, data, pol, m=1):
        nf4, b = data["nf4"], data["ad"].b
        k, n = nf4.shape[-2:]
        r = b.shape[-2]
        return (2 * m * k * n + 2 * m * r * (k + n),
                k * n // 2 + nf4.absmax.shape[-1] * 4
                + r * (k + n) * b.element_size())


def _qt_dims(qt: quant_lib.QuantizedLinear):
    """(D_in, D_out, groups) of a packed base, from its trailing dims."""
    return (qt.qweight.shape[-2] * quant_lib.codes_per_byte(qt.bits),
            qt.qweight.shape[-1], qt.scale.shape[-2])


def _qt_bytes(qt: quant_lib.QuantizedLinear) -> int:
    """Codes, scales and zeros of one packed base."""
    _, n, g = _qt_dims(qt)
    return (qt.qweight.shape[-2] + 2 * g * qt.scale.element_size()) * n


def _quantizer(pol: QuantPolicy, quantizer):
    """``quantizer`` or RTN under ``pol``."""
    return quantizer or (lambda w_: quant_lib.quantize(
        w_, pol.bits, pol.group_size, scale_dtype=pol.scale_dtype))


@register_scheme("qalora")
class QALoRAScheme(LinearScheme):
    """The paper: frozen INT-N group-wise base + group-pooled adapter,
    through the fused kernels (tiled or GEMV by M) on the card."""

    trainable = ("ad",)

    def init(self, generator, d_in, d_out, pol, device):
        w = _randn_weight(generator, d_in, d_out, device)
        qt = quant_lib.quantize(w, pol.bits, pol.group_size,
                                scale_dtype=pol.scale_dtype)
        del w
        return {"q": qt,
                "ad": qalora_lib.init_qalora(generator, qt.n_groups, pol.rank,
                                             d_out, pol.dtype, device=device)}

    def apply(self, data, x, pol):
        from repro_torch.kernels import ops
        return ops.qalora_matmul(x, data["q"], data["ad"], s=pol.s)

    def merge(self, data, pol):
        """Exact merge (Appendix B): zeros update only, stays INT-N."""
        return "intq", {"q": qalora_lib.merge(data["q"], data["ad"], pol.s)}

    def from_dense(self, generator, w, pol, quantizer=None):
        d_in, d_out = w.shape
        qt = _quantizer(pol, quantizer)(w.to(torch.float32))
        return {"q": qt,
                "ad": qalora_lib.init_qalora(generator, d_in // pol.group_size,
                                             pol.rank, d_out, pol.dtype,
                                             device=w.device)}

    def stack_ndim(self, data):
        return data["q"].qweight.dim() - 2

    def flops_bytes(self, data, pol, m=1):
        qt, b = data["q"], data["ad"].b
        k, n, g = _qt_dims(qt)
        r = b.shape[-2]
        return (2 * m * k * n + 2 * m * r * (g + n),
                _qt_bytes(qt) + r * (g + n) * b.element_size())


@register_scheme("qalora_slot")
class QALoRASlotScheme(LinearScheme):
    """Multi-tenant serving: one frozen INT-N base shared by a bank of
    QA-LoRA adapters, with one adapter index per batch row.

    The payload is ``{"q": QuantizedLinear, "a": [N, L, r] bank,
    "b": [N, r, D_out] bank, "ids": [B] int32}``; row b of x computes
    ``x_b @ dequant(q) + s * pool(x_b) @ A[ids_b] @ B[ids_b]``, and bank
    row 0 is the null adapter.  Built only by
    :meth:`repro_torch.serving.AdapterStore.with_slot_ids`."""

    def init(self, generator, d_in, d_out, pol, device):
        raise NotImplementedError(
            "qalora_slot linears are not initialized directly; build them "
            "from a base tree with repro_torch.serving.AdapterStore")

    def apply(self, data, x, pol):
        from repro_torch.kernels import ops
        ids = data["ids"]
        ids = ids.reshape(ids.shape + (1,) * (x.dim() - 1 - ids.dim()))
        return ops.qalora_slot_matmul(x, data["q"], data["a"], data["b"],
                                      ids.expand(x.shape[:-1]), s=pol.s)

    def merge(self, data, pol):
        raise NotImplementedError(
            "a qalora_slot linear banks many adapters, so it has no single "
            "merge target; use AdapterStore.merged(name) for one tenant's "
            "merged tree")

    def stack_ndim(self, data):
        return data["q"].qweight.dim() - 2

    def flops_bytes(self, data, pol, m=1):
        qt = data["q"]
        k, n, g = _qt_dims(qt)
        r = data["a"].shape[-1]
        # each row reads the shared base once plus its own adapter's rows
        return (2 * m * k * n + 2 * m * r * (g + n),
                _qt_bytes(qt) + m * r * (g + n) * data["b"].element_size())


@register_scheme("intq")
class IntQScheme(LinearScheme):
    """Bare INT-N group-wise linear: the merged QA-LoRA output, or a
    post-training quantization."""

    def init(self, generator, d_in, d_out, pol, device):
        w = _randn_weight(generator, d_in, d_out, device)
        return {"q": quant_lib.quantize(w, pol.bits, pol.group_size,
                                        scale_dtype=pol.scale_dtype)}

    def apply(self, data, x, pol):
        from repro_torch.kernels import ops
        return ops.qmatmul(x, data["q"])

    def merge(self, data, pol):
        return "intq", data

    def dense_view(self, data, pol, dtype=None):
        return quant_lib.dequantize(data["q"], dtype or torch.float32)

    def from_dense(self, generator, w, pol, quantizer=None):
        return {"q": _quantizer(pol, quantizer)(w.to(torch.float32))}

    def stack_ndim(self, data):
        return data["q"].qweight.dim() - 2

    def flops_bytes(self, data, pol, m=1):
        k, n, _ = _qt_dims(data["q"])
        return 2 * m * k * n, _qt_bytes(data["q"])


# ---------------------------------------------------------------------------
# single-linear entry points
# ---------------------------------------------------------------------------


def linear_init(generator, d_in: int, d_out: int, pol,
                device="cuda", exempt: bool = False) -> LinearParams:
    """Init one projection under ``pol`` (a QuantPolicy or a scoped
    PolicyTree).  ``exempt=True`` forces fp and tags the layer exempt
    (routers: the reference's ``quantize_policy=False``)."""
    rp = pol.resolve()
    if exempt:
        rp = dataclasses.replace(rp, mode="fp")
    scheme = get_scheme(rp.mode)
    return LinearParams(scheme.init(generator, d_in, d_out, rp, device),
                        scheme=rp.mode, policy=rp, exempt=exempt)


def from_dense_linear(generator, w, pol, quantizer=None,
                      exempt: bool = False) -> LinearParams:
    """A tagged linear of ``pol``'s scheme from the dense weight
    ``w [D_in, D_out]`` (see :meth:`LinearScheme.from_dense`)."""
    rp = pol.resolve()
    data = get_scheme(rp.mode).from_dense(generator, w, rp, quantizer)
    return LinearParams(data, scheme=rp.mode, policy=rp, exempt=exempt)


def linear_apply(lp: LinearParams, x):
    """Tag-driven forward."""
    return get_scheme(lp.scheme).apply(lp.data, x, lp.policy)


def merge_linear(lp: LinearParams) -> LinearParams:
    """Merge adapters for deployment.  QA-LoRA stays quantized (exact);
    LoRA and QLoRA fall back to fp (the paper's '4+16' row).
    Idempotent."""
    name, data = get_scheme(lp.scheme).merge(lp.data, lp.policy)
    return LinearParams(data, scheme=name,
                        policy=dataclasses.replace(lp.policy, mode=name),
                        exempt=lp.exempt)


def dense_view(lp: LinearParams, dtype=None):
    """Effective (adapter-included) dense weight in ``dtype`` (or the
    storage dtype)."""
    return get_scheme(lp.scheme).dense_view(lp.data, lp.policy, dtype)


# ---------------------------------------------------------------------------
# tree walkers
# ---------------------------------------------------------------------------


def map_linears(module: nn.Module, fn, path: str = "") -> nn.Module:
    """A copy of ``module`` with every :class:`LinearParams` replaced by
    ``fn(path, lp)``.  Containers are copied shallowly: buffers that no
    linear replaces are shared with the input, not duplicated."""
    if isinstance(module, LinearParams):
        return fn(path, module)
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    out._modules = {k: (map_linears(v, fn, f"{path}/{k}" if path else k)
                        if v is not None else None)
                    for k, v in module._modules.items()}
    return out


def merge_tree(params: nn.Module) -> nn.Module:
    """Merge every adapter in the model into its base (tag-driven walk);
    idempotent.  A shard's linears keep their tensor-parallel mode
    (``tp``, :mod:`repro_torch.sharding.shard`): the merge is local to
    each (group, column), so the merged shard is the merged tree's."""
    def one(path, lp):
        out = merge_linear(lp)
        if "tp" in lp.__dict__:
            out.tp = lp.tp
        return out
    return map_linears(params, one)


def _policy_path(path: str) -> str:
    """A module path as the reference's policy path: the per-layer index
    dropped (``blocks/3/attn/wq`` -> ``blocks/attn/wq``), the head named
    ``lm_head``."""
    return _norm_head("/".join(p for p in path.split("/") if not p.isdigit()))


def convert_tree(params: nn.Module, pol, generator=None, quantizer=None):
    """Re-store every linear under the (possibly per-layer) target policy
    ``pol``: ``from_dense(dense_view(p))``, on each linear's device.
    Exempt linears, linears whose policy already is the target's, and
    quantized targets whose D_in the group size does not divide keep (or,
    for the last, fall back to) fp storage.  ``quantizer`` replaces RTN
    for quantized bases (e.g. a GPTQ closure ``w -> QuantizedLinear``).
    Adapters are drawn from ``generator`` (default: seed 0 on the first
    converted linear's device), which each linear advances in turn."""
    state = {"gen": generator}

    def one(path, lp: LinearParams):
        if lp.exempt:
            return lp
        tp = resolve_path(pol, _policy_path(path))
        if tp.mode == lp.scheme and tp == lp.policy:
            return lp
        w = dense_view(lp, dtype=torch.float32)
        if tp.mode != "fp" and w.shape[0] % tp.group_size != 0:
            return dense_linear(w.to(lp.policy.dtype), lp.policy)
        if tp.mode == "fp":
            return dense_linear(w.to(tp.dtype), tp)
        if state["gen"] is None:
            state["gen"] = torch.Generator(device=w.device).manual_seed(0)
        return from_dense_linear(state["gen"], w, tp, quantizer=quantizer,
                                 exempt=lp.exempt)

    return map_linears(params, one)


def trainable_tensors(params: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainable (adapter) tensors of a params module, by the names
    ``params.named_parameters()`` gives them, found through each scheme's
    :meth:`LinearScheme.trainable_paths` (the counterpart of the
    reference's ``trainable_mask``; a module needs no mask, since
    everything else is a buffer).

    Raises when a scheme declares a trainable key that is missing or
    selects no tensor for some layer (a misnamed payload would otherwise
    train nothing), and when the set found differs from
    ``params.parameters()``: autograd must build gradients for exactly
    these tensors, never for the frozen base, embedding, norms or head."""
    out: Dict[str, torch.Tensor] = {}
    for name, lp in params.named_modules():
        if not isinstance(lp, LinearParams):
            continue
        path = name.replace(".", "/") or "<root>"
        data = lp.data
        tp = tuple(get_scheme(lp.scheme).trainable_paths(data))
        missing = sorted(set(tp) - set(data))
        if missing:
            raise ValueError(
                f"scheme '{lp.scheme}' at '{path}' declares trainable "
                f"key(s) {missing} but the params only hold {sorted(data)} "
                f"— nothing would train for this layer")
        for key in tp:
            v = data[key]
            found = ({f"{key}.{n}": t for n, t in v.named_parameters()}
                     if isinstance(v, nn.Module) else {key: v})
            if not found:
                raise ValueError(f"scheme '{lp.scheme}' at '{path}': "
                                 f"trainable key '{key}' selects zero "
                                 f"tensors")
            prefix = f"{name}." if name else ""
            out.update({prefix + n: t for n, t in found.items()})
    declared = {id(t) for t in out.values()}
    actual = {id(t) for t in params.parameters()}
    if declared != actual:
        names = dict(params.named_parameters())
        extra = sorted(n for n, t in names.items() if id(t) not in declared)
        raise ValueError(
            f"the schemes' trainable tensors differ from the module's "
            f"parameters: {extra[:4]} are parameters no scheme declares, "
            f"{len(declared - actual)} declared tensors are not parameters")
    return out


def _first_leaf(data: dict) -> torch.Tensor:
    """The payload's first tensor, in the payload's order (the
    reference's ``jax.tree.leaves(data)[0]``)."""
    v = next(iter(data.values()))
    return next(v.buffers()) if isinstance(v, nn.Module) else v


def tree_flops_bytes(params, m: int = 1):
    """Sum of (flops, weight bytes) over every linear of ``params`` (a
    module, or a dict or list of them) for an ``[m, D_in]`` activation
    each: the scheme-aware roofline numerator, plain ints.  A stacked
    payload counts each member.  Works on ``meta`` params at any width:
    only shapes are read."""
    mods = params.values() if isinstance(params, dict) else \
        params if isinstance(params, (list, tuple)) else (params,)
    flops = nbytes = 0
    for mod in mods:
        for lp in mod.modules():
            if not isinstance(lp, LinearParams):
                continue
            scheme, data = get_scheme(lp.scheme), lp.data
            nd = scheme.stack_ndim(data)
            stack = math.prod(int(d) for d in _first_leaf(data).shape[:nd])
            f, b = scheme.flops_bytes(data, lp.policy, m)
            flops += int(f) * stack
            nbytes += int(b) * stack
    return flops, nbytes
