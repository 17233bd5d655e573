"""The port's partition specs (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding``), spec for spec.

The reference's ``param_specs`` runs over an ``AbstractMesh`` (no
devices), on ``jax.eval_shape`` of ``LM.init``; the port's over its own
params on the meta device.  Both at the configs' full widths, with the
depth cut to two layers of each stack (the rules never shard a layer
axis).  A reference leaf is stacked ``[L, ...]`` (``[L, E, ...]`` for an
expert); the port holds one leaf per layer (and expert), so the
reference's spec is compared with its stack entries dropped.  The cases of
``tests/test_sharding.py`` are mirrored at the end.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402
from jax.tree_util import DictKey, GetAttrKey  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.sharding import batch_spec_tree as ref_batch_specs  # noqa: E402
from repro.sharding import cache_spec_tree as ref_cache_specs  # noqa: E402
from repro.sharding import param_specs as ref_param_specs  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _abstract_mesh(sizes, names):
    """AbstractMesh across jax versions: old API took (sizes, names),
    newer ones take a ((name, size), ...) shape tuple."""
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _cut(arch):
    """Full widths, two layers of each stack."""
    cfg = TC.get(arch)
    cut = {"n_layers": 2}
    if cfg.family == "mla_moe":
        cut["n_dense_layers"] = 1
    if cfg.family == "encdec":
        cut["n_enc_layers"] = 1
    if cfg.family == "mamba_hybrid":
        cut["n_layers"] = cfg.attn_every + 1  # a group and a tail
    return cut


def _ref_names(path):
    """The reference's tree names of a leaf, without the ``data``
    attribute of its linears (the port's linears have no such level)."""
    out = []
    for k in path:
        if isinstance(k, DictKey):
            out.append(str(k.key))
        elif isinstance(k, GetAttrKey) and k.name != "data":
            out.append(k.name)
    return tuple(out)


def _flat_specs(tree, specs):
    """``{names: (spec padded to the leaf's dims, ndim)}``."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return {_ref_names(path): (rules.padded(tuple(s), len(x.shape)),
                               len(x.shape))
            for (path, x), s in zip(leaves, sp)}


@pytest.fixture(scope="module", params=RC.ASSIGNED)
def trees(request):
    arch = request.param
    cut = _cut(arch)
    ref = jax.eval_shape(RLM(RC.get(arch).scaled(**cut)).init,
                         jax.random.PRNGKey(0))
    port = TLM(TC.get(arch).scaled(**cut)).init(torch.Generator(), "meta")
    return arch, ref, port


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_reference(trees, mesh):
    arch, ref, port = trees
    sizes, names = MESHES[mesh]
    want = _flat_specs(ref, ref_param_specs(ref, _abstract_mesh(sizes, names)))
    got = rules.param_specs(port, dict(zip(names, sizes)))
    assert {rules.leaf_names(n)[0] for n in got} == set(want), arch
    for name, spec in got.items():
        leaf, index = rules.leaf_names(name)
        rspec, nd = want[leaf]
        assert spec == rspec[len(index):], (arch, mesh, name, spec, rspec)


@pytest.mark.parametrize("arch", ["deepseek-67b", "deepseek-v3-671b",
                                  "rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    cfg = _cut(arch)
    rlm = RLM(RC.get(arch).scaled(**cfg))
    tlm = TLM(TC.get(arch).scaled(**cfg))
    for batch, seq in ((128, 4096), (1, 65536)):
        ref = jax.eval_shape(lambda: rlm.init_cache(batch, seq))
        want = _flat_specs(ref, ref_cache_specs(
            ref, _abstract_mesh(sizes, names)))
        port = tlm.init_cache(batch, seq, device="meta")
        got = rules.cache_spec_tree(port, dict(zip(names, sizes)))

        def walk(node, spec, path=()):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], spec[k], path + (k,))
                return
            if path in want:
                rspec, nd = want[path]
                assert rules.padded(spec, node.dim()) == rspec, \
                    (arch, mesh, path, spec, rspec)
                seen.append(path)
        seen = []
        walk(port, got)
        assert seen, (arch, "no cache leaf named as the reference's")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [(256, 4096), (3, 64), (1, 64),
                                   (32, 8, 16)])
def test_batch_specs_equal_the_reference(mesh, shape):
    sizes, names = MESHES[mesh]
    batch = {"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}
    want = ref_batch_specs(batch, _abstract_mesh(sizes, names))["tokens"]
    got = rules.batch_spec_tree({"tokens": torch.empty(shape)},
                                dict(zip(names, sizes)))["tokens"]
    assert rules.padded(got, len(shape)) == rules.padded(tuple(want),
                                                         len(shape))


# --- the cases of tests/test_sharding.py -----------------------------------

POD = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def _port_specs(arch, mesh=POD):
    cfg = TC.get(arch).scaled(**_cut(arch))
    return rules.param_specs(TLM(cfg).init(torch.Generator(), "meta"), mesh)


def test_megatron_pairing():
    """wq col-parallel, wo row-parallel, adapters follow their base."""
    s = _port_specs("deepseek-67b")
    assert s["blocks.0.attn.wq.q.qweight"][-1] == "model"      # col
    assert s["blocks.0.attn.wo.q.qweight"][-2] == "model"      # row
    assert s["blocks.0.attn.wq.ad.b"][-1] == "model"           # B with N
    assert s["blocks.0.attn.wo.ad.a"][-2] == "model"           # A with K
    assert s["blocks.0.attn.wq.ad.a"] == (None, None)
    assert s["embed"] == ("model", None) and s["head.w"] == (None, "model")


def test_expert_dim_sharded_full_mesh():
    """DeepSeek-V3: 256 experts = ("data", "model") on the 16x16 pod (the
    rule on the reference's stacked [L, E, Kp, N] shape)."""
    cfg = TC.get("deepseek-v3-671b")
    spec = rules.spec_for_param(
        ("moe_blocks", "moe", "gate", "q", "qweight"),
        (58, cfg.n_experts, cfg.d_model // 2, cfg.moe_d_ff), POD)
    assert spec[1] == ("data", "model")


def test_mixtral_experts_fall_back_to_tp():
    s = _port_specs("mixtral-8x22b")
    # 8 experts can't shard 16 ways -> expert dim replicated, d_ff sharded
    assert s["blocks.0.moe.gate.0.q.qweight"] == (None, "model")


def test_pick_falls_back_to_replication():
    assert rules._pick([("model",), ("data",)], (7,),
                       {"data": 16, "model": 16}) == ()


def test_mid_group_row_shard_keeps_scales_replicated():
    """Reduced gemma3-1b's down at model 4: K = 96, g = 16 -> 6 groups do
    not split 4 ways, so its scales, zeros and A are replicated while its
    48 packed rows are sharded (12 a rank: mid-group)."""
    cfg = TC.reduced("gemma3-1b")
    s = rules.param_specs(TLM(cfg).init(torch.Generator(), "meta"),
                          {"data": 1, "model": 4})
    down = "blocks.0.mlp.down."
    assert s[down + "q.qweight"] == ("model", None)
    assert s[down + "q.scale"] == s[down + "ad.a"] == (None, None)
    assert s["blocks.0.attn.wk.q.qweight"] == (None, "model")


def test_batch_specs_dp():
    s = rules.batch_spec_tree({"tokens": (256, 4096)}, MULTI)
    assert s["tokens"][0] == ("pod", "data")
    # batch=1 falls back to replication rather than erroring
    assert rules.batch_spec_tree({"tokens": (1, 64)}, MULTI)["tokens"] == ()


def test_spec_axes_and_padding():
    assert rules.spec_axes((("pod", "data"), None, "model")) == \
        ("pod", "data", "model")
    assert rules.padded((), 3) == (None, None, None)
    assert np.prod([MULTI[a] for a in rules.spec_axes(
        (("pod", "data"), None))]) == 32


def test_train_state_specs_split_the_param_specs():
    """The trainable, frozen and optimizer specs of ``train_state_specs``
    are the model's param specs over each half (llama7b-proxy's full
    widths, two layers, on the meta device)."""
    from repro_torch.launch.steps import train_state_specs
    lm = TLM(TC.get("llama7b-proxy").scaled(n_layers=2))
    tspec, fspec, ospec = train_state_specs(lm, POD)
    whole = rules.param_specs(lm.init(torch.Generator(), "meta"), POD)
    assert {**tspec, **fspec} == whole and not set(tspec) & set(fspec)
    assert all(k.endswith((".ad.a", ".ad.b")) for k in tspec)
    assert ospec["mu"] == ospec["nu"] == tspec and ospec["step"] == ()
    assert tspec["blocks.0.attn.wq.ad.b"] == (None, "model")
