"""The gqa decode step on a mesh of CPU processes (gloo), the program the
dry run (``repro_torch.launch.dryrun``) counts for a decode cell, against
the JAX package's ``LM.decode_step`` (run without a mesh).

The reference's params (``LM.init``, adapters nudged by +0.01) and its
prefilled cache go to every rank as numpy; each rank carries the params
across with ``repro_torch.bridge.load_numpy_tree``, holds its shard
(``shard_params``) and its part of the cache (``dryrun.rank_cache``: the
reference's ``cache_spec_tree``); its decode step runs the attention over
the KV heads its query heads read (``tp.qkv``, ``tp.rank_kv_heads``) and
gives its block of the vocabulary's logits.  The blocks concatenated over
"model" and each rank's updated cache are held to the reference's within
1e-5 of the largest magnitude (f32).  Reduced llama7b-proxy (4 query
heads, 2 KV heads of 16) on model 2 shards whole KV heads; on model 4
the reference's cache spec splits the head dim instead, which the port
refuses.  The ranks import this module, not JAX: JAX is imported inside
the test that runs the reference."""

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.lm import LM as TLM
from repro_torch.sharding import shard_params

ARCH = "llama7b-proxy"
B, PROMPT, CAP = 2, 8, 12
TOL = 1e-5


def _setup():
    """The reduced model, a prefilled full cache and the next tokens."""
    cfg = TC.reduced(ARCH)
    lm = TLM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), "cpu")
    toks = (torch.arange(B * PROMPT, dtype=torch.int32).reshape(B, PROMPT)
            * 7 + 3) % cfg.vocab
    cache = lm.init_cache(B, CAP, dtype=torch.float32, device="cpu")
    logits, pre = lm.prefill(params, {"tokens": toks})
    lm.merge_prefill_cache(pre, cache)
    nxt = logits.argmax(dim=-1).to(torch.int32)[:, None]
    return cfg, lm, params, cache, nxt


def _reference():
    """The reference's params (numpy layout), its prefilled cache (numpy),
    the next tokens, and its decode step's logits and updated cache."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.configs as RC
    from repro.models.lm import LM as RLM
    from _torch_parity import bump, numpy_tree
    rlm = RLM(RC.reduced(ARCH))
    params = bump(rlm.init(jax.random.PRNGKey(0)))
    toks = (jnp.arange(B * PROMPT, dtype=jnp.int32).reshape(B, PROMPT)
            * 7 + 3) % rlm.cfg.vocab
    logits, pre = jax.jit(rlm.prefill)(params, {"tokens": toks})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(B, CAP, dtype=jnp.float32))
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    step, out = jax.jit(rlm.decode_step)(params, cache, nxt)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (numpy_tree(params), as_np(cache), np.asarray(nxt),
            np.asarray(step), as_np(out))


def rank_decode(rank, sizes, names, tree, cache_np, nxt):
    cfg = TC.reduced(ARCH)
    lm = TLM(cfg)
    params = bridge.load_numpy_tree(tree, cfg, "cpu")
    cache = {"layers": {k: torch.from_numpy(v)
                        for k, v in cache_np["layers"].items()},
             "len": torch.from_numpy(cache_np["len"])}
    mesh = make_mesh(sizes, names)
    shard = shard_params(params, mesh)
    mine = dryrun.rank_cache(cache, mesh)
    dryrun.check_decode_mesh_support(cfg, shard, mine, mesh, CAP)
    with torch.no_grad():
        logits, out = lm.decode_step(shard, mine, torch.from_numpy(nxt))
    return (logits.numpy(), out["layers"]["k"].numpy(),
            out["layers"]["v"].numpy(), out["len"].numpy())


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30))


def test_decode_on_model_2_equals_reference():
    tree, cache, nxt, want, full = _reference()
    got = run_ranks(rank_decode, 2, ((1, 2), ("data", "model"), tree, cache,
                                     nxt), deadline_s=150.0)
    _close(np.concatenate([g[0] for g in got], axis=-1), want)
    for r, (_, k, v, length) in enumerate(got):   # KV head r of the 2
        _close(k, full["layers"]["k"][..., r:r + 1, :])
        _close(v, full["layers"]["v"][..., r:r + 1, :])
        np.testing.assert_array_equal(length, full["len"])


def test_decode_refused_where_the_cache_spec_splits_head_dim():
    """On model 4 the reference's cache spec splits the 2 KV heads' head
    dim (2 does not divide over 4): the port's decode holds whole heads,
    so the cell is refused with the reason, naming ROADMAP.md."""
    cfg, lm, params, cache, _ = _setup()
    with dryrun.fake_mesh((1, 4), ("data", "model"), rank=1) as mesh:
        shard = shard_params(params, mesh)
        mine = dryrun.rank_cache(cache, mesh)
        assert tuple(mine["layers"]["k"].shape[-2:]) == (2, 4)
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
            dryrun.check_decode_mesh_support(cfg, shard, mine, mesh, CAP)
    assert "(2, 12, 2, 4)" in str(e.value)
    assert "(2, 12, 1, 16)" in str(e.value)
