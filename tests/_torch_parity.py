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
            return {"scheme": "fp", "weight": np.asarray(RS.dense_view(lp))}
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
