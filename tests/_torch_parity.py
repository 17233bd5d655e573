"""Helpers shared by the port's parity tests: reference parameter trees
as the bridge's numpy layout (``repro_torch.bridge``), read through the
reference's scheme API."""

import jax
import numpy as np

from repro.core import schemes as RS


def bump(params):
    """+0.01 on every adapter leaf, as the reference serve driver does."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 if any(
            getattr(k, "key", None) == "ad" for k in path) else x, params)


def numpy_tree(params):
    """A reference params tree as the bridge's numpy layout."""
    def lin(lp):
        if lp.scheme == "fp":
            return {"scheme": "fp", "weight": np.asarray(RS.dense_view(lp)),
                    **({"exempt": True} if lp.exempt else {})}
        if lp.scheme in ("lora", "qlora"):
            ad = RS.adapter_params(lp)
            d = {"scheme": lp.scheme, "s": lp.policy.s, "a": np.asarray(ad.a),
                 "b": np.asarray(ad.b)}
            # the frozen base: what the scheme does not declare trainable
            trainable = RS.get_scheme(lp.scheme).trainable_paths(lp.data)
            (base,) = [v for k, v in lp.items() if k not in trainable]
            if lp.scheme == "lora":
                d["weight"] = np.asarray(base)
            else:
                d.update(codes=np.asarray(base.codes),
                         absmax=np.asarray(base.absmax), shape=base.shape,
                         block=base.block)
            return d
        qt = RS.quantized_base(lp)
        d = {"scheme": lp.scheme, "bits": qt.bits,
             "group_size": qt.group_size,
             "qweight": np.asarray(qt.qweight), "scale": np.asarray(qt.scale),
             "zero": np.asarray(qt.zero)}
        if lp.scheme == "qalora":
            ad = RS.adapter_params(lp)
            d.update(s=lp.policy.s, a=np.asarray(ad.a), b=np.asarray(ad.b))
        return d

    def walk(p):
        if RS.is_linear(p):
            return lin(p)
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        return np.asarray(p)
    return walk(params)


def _adapter_leaf(path):
    """(layout path, "a" or "b") of a reference adapter leaf, else None:
    ``blocks/attn/wq/<data>/ad/a`` -> (("blocks", "attn", "wq"), "a")."""
    keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    if len(keys) < 3 or keys[-2] != "ad" or keys[-3] != "data":
        return None
    return tuple(keys[:-3]), keys[-1]


def ref_adapters(tree):
    """The adapter leaves of a reference tree (params, trainable half,
    gradients or AdamW moments) in the layout of
    ``repro_torch.bridge.adapters_numpy``."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        where = _adapter_leaf(path)
        if where is None:
            continue
        node = out
        for k in where[0]:
            node = node.setdefault(k, {})
        node[where[1]] = np.asarray(x)
    return out


def with_adapters(params, adapters):
    """The reference tree ``params`` with its adapters replaced by the
    arrays of ``adapters`` (the ``adapters_numpy`` layout)."""
    def one(path, x):
        where = _adapter_leaf(path)
        if where is None:
            return x
        node = adapters
        for k in where[0]:
            node = node[k]
        new = node[where[1]]
        assert new.shape == x.shape, (where, new.shape, x.shape)
        return jax.numpy.asarray(new, x.dtype)
    return jax.tree_util.tree_map_with_path(one, params)
