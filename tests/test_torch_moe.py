"""Parity of the port's mixture-of-experts FFN (``repro_torch.models.moe``)
with the JAX package's, on the CPU in f32: the positions within an
expert, the routing (softmax and sigmoid with its bias), the capacity
drops, the shared experts, the chunked prefill routing, and the bridge's
MoE tree both ways.

Inputs are made with numpy from seeds; reference parameters go to the
port through ``repro_torch.bridge``; the reference runs without a mesh.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import bump, numpy_tree, ref_adapters  # noqa: E402

D, D_FF, E, K = 64, 32, 4, 2
TOL_Y, TOL_AUX = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(autouse=True)
def _no_grad():
    """Forward passes only: the adapters are parameters."""
    with torch.no_grad():
        yield


@pytest.mark.parametrize("tk, n_experts, seed",
                         [(1, 4, 0), (16, 4, 1), (64, 8, 2), (256, 8, 3),
                          (96, 256, 4)])
def test_positions_in_expert_equal_reference(tk, n_experts, seed):
    """The rank of each assignment within its expert, from a stable
    argsort: equal to the reference's as integers, skewed ids included."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, n_experts, size=(tk,))
    flat[: tk // 3] = 0  # one hot expert
    ref = np.asarray(RM._positions_in_expert(jnp.asarray(flat, jnp.int32),
                                             n_experts))
    got = TM._positions_in_expert(_t(flat.astype(np.int64)), n_experts)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def _stack_layer(tree):
    """A one-layer tree as the bridge's ``[L, ...]`` layout."""
    if isinstance(tree, dict):
        return {k: _stack_layer(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return tree[None]
    return tree


def _moe_pair(routing, n_shared, seed=0):
    """A reference MoE layer (bias random under sigmoid routing) and the
    same weights as the port's ``MoEParams``."""
    pol = RC.SMOKE_QUANT
    p = RM.moe_init(jax.random.PRNGKey(seed), D, D_FF, E, pol,
                    n_shared=n_shared, shared_d_ff=D_FF, routing=routing)
    p = bump({"x": p})["x"]
    if routing == "sigmoid":
        p["bias"] = jnp.asarray(np.random.default_rng(seed).normal(
            scale=0.3, size=(E,)).astype(np.float32))
    cfg = TC.reduced("mixtral-8x22b", n_experts=E, routing=routing,
                     n_shared_experts=n_shared)
    tp = bridge._moe(_stack_layer(numpy_tree(p)), cfg, "cpu", 0)
    return p, tp


CASES = [dict(routing=r, n_shared=n, capacity=c, chunk=ch)
         for r in ("softmax", "sigmoid") for n in (0, 1)
         for c in (8.0, 0.25) for ch in (0, 8)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_moe_apply_matches_reference(case):
    """moe_apply: y within 1e-5 and aux within 1e-6 of the reference's;
    the routing (expert ids, ranks within an expert, the kept
    assignments) identical as integers, per routing chunk."""
    p, tp = _moe_pair(case["routing"], case["n_shared"])
    x = np.random.default_rng(1).normal(size=(2, 16, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=case["capacity"],
              routing=case["routing"], act="silu", moe_chunk=case["chunk"])
    ry, raux = RM.moe_apply(p, jnp.asarray(x), RC.SMOKE_QUANT, **kw)
    with TM.record_routing() as rec:
        ty, taux = TM.moe_apply(tp, _t(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=TOL_Y,
                               rtol=0)
    assert abs(float(taux) - float(raux)) <= TOL_AUX
    # the routing, chunk by chunk, against the reference's own functions
    (route,) = rec
    c = case["chunk"] or x.shape[1]
    dropped = 0
    for i in range(0, x.shape[1], c):
        xc = x[:, i:i + c].reshape(-1, D)
        t = xc.shape[0]
        _, ridx, _ = RM._route(p, jnp.asarray(xc), E, K, case["routing"],
                               RC.SMOKE_QUANT)
        ridx = np.asarray(ridx)
        tidx = route["idx"][:, i:i + c].reshape(t, K)
        np.testing.assert_array_equal(tidx.numpy(), ridx)
        rpos = np.asarray(RM._positions_in_expert(
            jnp.asarray(ridx.reshape(-1)), E))
        tpos = TM._positions_in_expert(tidx.reshape(-1), E)
        np.testing.assert_array_equal(tpos.numpy(), rpos)
        cap = max(int(np.ceil(K * t / E * case["capacity"])), 1)
        np.testing.assert_array_equal(
            route["keep"][:, i:i + c].reshape(-1).numpy(), rpos < cap)
        dropped += int((rpos >= cap).sum())
    assert (dropped > 0) == (case["capacity"] < 1.0)


@pytest.mark.parametrize("routing", ("softmax", "sigmoid"))
def test_route_gates_and_aux_match_reference(routing):
    """_route: gates within 1e-6 (renormalised with max(sum, 1e-9)), ids
    identical, the Switch aux within 1e-6; the router stays fp, tagged
    exempt, and conversion leaves it alone."""
    p, tp = _moe_pair(routing, 0, seed=3)
    x2 = np.random.default_rng(2).normal(size=(24, D)).astype(np.float32)
    rg, ri, ra = RM._route(p, jnp.asarray(x2), E, K, routing, RC.SMOKE_QUANT)
    tg, ti, ta = TM._route(tp, _t(x2), E, K, routing)
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert abs(float(ta) - float(ra)) <= TOL_AUX
    assert tp.router.scheme == "fp" and tp.router.exempt
    conv = TS.convert_tree(tp, TS.PolicyTree.parse("*=intq8"))
    assert conv.router is tp.router
    assert {conv.gate[e].scheme for e in range(E)} == {"intq"}


def test_moe_init_tags_router_exempt_and_stacks_experts():
    """moe_init: an exempt fp router, E quantized linears a projection
    under the policy paths ``moe/gate``, ``moe/up``, ``moe/down``, a zero
    f32 bias only under sigmoid routing, and the shared experts' MLP."""
    pol = TS.PolicyTree.parse("*=qalora,*/moe/down=intq8",
                              base=TC.SMOKE_QUANT)
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, D, D_FF, E, pol.at("blocks").at("moe"),
                    n_shared=1, shared_d_ff=D_FF, routing="sigmoid",
                    device="cpu")
    assert p.router.scheme == "fp" and p.router.exempt
    assert len(p.gate) == len(p.up) == len(p.down) == E
    assert [lp.scheme for lp in p.gate] == ["qalora"] * E
    assert [lp.scheme for lp in p.down] == ["intq"] * E
    assert p.bias.dtype == torch.float32 and not p.bias.any()
    assert set(p.shared.keys()) == {"gate", "up", "down"}
    q = TM.moe_init(gen, D, D_FF, E, TC.SMOKE_QUANT, device="cpu")
    assert q.bias is None and q.shared is None


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^
                                                          set(b))
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("routing, n_shared", [("softmax", 0),
                                               ("sigmoid", 1)])
def test_bridge_round_trips_the_moe_tree(routing, n_shared):
    """load_numpy_tree then numpy_tree gives back the reference's MoE tree
    leaf for leaf (expert linears stacked [L, E, ...], the exempt fp
    router, the sigmoid bias [L, E], the shared experts), and
    adapters_numpy gives the reference's adapter leaves."""
    rcfg = RC.reduced("mixtral-8x22b", routing=routing,
                      n_shared_experts=n_shared)
    tcfg = TC.reduced("mixtral-8x22b", routing=routing,
                      n_shared_experts=n_shared)
    params = bump(RLM(rcfg).init(jax.random.PRNGKey(0)))
    tree = numpy_tree(params)
    moe_t = tree["blocks"]["moe"]
    assert moe_t["router"]["exempt"] is True
    assert moe_t["gate"]["qweight"].shape[:2] == (rcfg.n_layers, E)
    assert ("bias" in moe_t) == (routing == "sigmoid")
    tp = bridge.load_numpy_tree(tree, tcfg, "cpu")
    blk = tp.blocks[1]["moe"]
    assert isinstance(blk, TM.MoEParams) and len(blk.gate) == E
    assert blk.router.exempt and (blk.shared is not None) == bool(n_shared)
    _leaves_equal(tree, bridge.numpy_tree(tp))
    _leaves_equal(ref_adapters(params), bridge.adapters_numpy(tp))


def test_moe_step_needs_no_host_read(monkeypatch):
    """The MoE FFN of a decode or ragged step reads nothing back to the
    host (a captured CUDA graph could not): ``.item()``, ``.tolist()``,
    ``nonzero`` and ``__bool__`` on a tensor are never called."""
    _, tp = _moe_pair("softmax", 1)
    x = _t(np.random.default_rng(4).normal(size=(4, 1, D))
           .astype(np.float32))

    def boom(*a, **k):
        raise AssertionError("host read inside the MoE step")
    for name in ("item", "tolist", "nonzero", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    y, _ = TM.moe_apply(tp, x, n_experts=E, top_k=K, routing="softmax")
    monkeypatch.undo()
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_prefill_length_must_be_a_multiple_of_moe_chunk():
    """Chunked routing takes whole chunks, as the reference asserts."""
    _, tp = _moe_pair("softmax", 0)
    x = torch.zeros((1, 12, D))
    with pytest.raises(ValueError, match="moe_chunk"):
        TM.moe_apply(tp, x, n_experts=E, top_k=K, moe_chunk=8)


def test_layer_linears_count_from_the_config():
    """LM.layer_linears: 7 a gated dense layer, 6 with a non-gated MLP,
    4 + 3 E (+ 3 with shared experts) for an MoE layer, its router fp;
    equal to the quantized linears an init holds."""
    want = {"llama7b-proxy": 7, "h2o-danube-1.8b": 7, "deepseek-67b": 7,
            "starcoder2-7b": 6, "mixtral-8x22b": 28}
    for arch, n in want.items():
        assert TLM(TC.get(arch)).layer_linears() == n, arch
    for over in ({}, {"n_shared_experts": 1}):
        cfg = TC.reduced("mixtral-8x22b", **over)
        lm = TLM(cfg)
        params = lm.init(torch.Generator().manual_seed(0), "cpu")
        quantized = [m for m in params.blocks[0].modules()
                     if TS.is_linear(m) and m.scheme != "fp"]
        assert len(quantized) == lm.layer_linears() == 4 + 3 * E + (
            3 if over else 0)


def test_reduced_moe_config_matches_reference():
    """reduced('mixtral-8x22b') and the full config carry the reference's
    MoE fields (4 experts, top-2, moe_d_ff 32, moe_chunk 16 reduced, the
    aux loss's weight 0.01, which ``LM.loss`` reads); the fields no port
    code reads yet are left out (``n_dense_layers`` is read since mla_moe
    is ported)."""
    fields = [f.name for f in dataclasses.fields(TC.ArchConfig)
              if f.name != "quant"]
    for r, t in ((RC.get("mixtral-8x22b"), TC.get("mixtral-8x22b")),
                 (RC.reduced("mixtral-8x22b"), TC.reduced("mixtral-8x22b"))):
        for name in fields:
            assert getattr(t, name) == getattr(r, name), name
    red = TC.reduced("mixtral-8x22b")
    assert (red.n_experts, red.top_k, red.moe_d_ff, red.moe_chunk,
            red.aux_coef) == (4, 2, 32, 16, 0.01)
    for unread in ("seq_parallel",):
        assert not hasattr(red, unread), unread
