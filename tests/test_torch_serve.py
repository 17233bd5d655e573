"""Parity of the PyTorch port's gqa model and static serve path with the
JAX package, on the CPU, at reduced sizes.

The reference tree from ``LM.init`` (adapters nudged by +0.01, as its
serve driver does) goes to the port through numpy and
``repro_torch.bridge.load_numpy_tree``; the reference runs without a mesh
(``jax.jit(lm.prefill)`` -> ``merge_prefill_cache`` -> ``LM.generate``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import bump as _bump, numpy_tree as _numpy_tree  # noqa: E402

ARCHS = ("gemma3-1b", "llama7b-proxy")
GEN_LEN = 5
TOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    params = _bump(rlm.init(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    prompts = np.random.default_rng(0).integers(
        4, rcfg.vocab, size=(2, 6)).astype(np.int32)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg),
        params=params, merged=merged, prompts=prompts,
        max_len=prompts.shape[1] + GEN_LEN,
        tparams=bridge.load_numpy_tree(_numpy_tree(params), tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(_numpy_tree(merged), tcfg, "cpu"))


def _ref_prefill_decode(p, params):
    """Reference prefill logits, decode cache and one decode step."""
    toks = jnp.asarray(p.prompts)
    logits, pre = jax.jit(p.rlm.prefill)(params, {"tokens": toks})
    cache = p.rlm.merge_prefill_cache(
        pre, p.rlm.init_cache(toks.shape[0], p.max_len, dtype=jnp.float32))
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    step, _ = jax.jit(p.rlm.decode_step)(params, cache, nxt)
    return np.asarray(logits), cache, np.asarray(step)


def _port_prefill_decode(p, params):
    toks = torch.from_numpy(p.prompts)
    logits, pre = p.tlm.prefill(params, {"tokens": toks})
    cache = p.tlm.merge_prefill_cache(
        pre, p.tlm.init_cache(toks.shape[0], p.max_len, dtype=torch.float32,
                              device="cpu"))
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    step, _ = p.tlm.decode_step(params, cache, nxt)
    return logits.numpy(), step.numpy()


def test_port_config_matches_reference(pair):
    keep = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab", "head_dim", "rope_theta", "window", "global_every",
            "global_rope_theta", "qk_norm", "gated_mlp", "act", "norm_eps",
            "tie_embeddings", "chunk_q", "chunk_k")
    for name in keep:
        assert getattr(pair.tcfg, name) == getattr(pair.rcfg, name), name
    for name in ("bits", "group_size", "rank", "s", "use_kernel"):
        assert getattr(pair.tcfg.quant, name) == getattr(pair.rcfg.quant, name)
    full_r, full_t = RC.get(pair.arch), TC.get(pair.arch)
    for name in keep:
        assert getattr(full_t, name) == getattr(full_r, name), name


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_and_decode_logits_match(pair, which):
    rparams = pair.params if which == "adapter" else pair.merged
    tparams = pair.tparams if which == "adapter" else pair.tmerged
    r_logits, _, r_step = _ref_prefill_decode(pair, rparams)
    t_logits, t_step = _port_prefill_decode(pair, tparams)
    np.testing.assert_allclose(t_logits, r_logits, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_step, r_step, atol=TOL, rtol=0)


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_kernel_routed_model_matches_reference(pair, which):
    """The port's quantized linears go through the kernel wrappers, which
    take the kernels' plain versions on the CPU through the same dispatch
    the card uses; no kernel launches are counted."""
    rparams = pair.params if which == "adapter" else pair.merged
    tparams = pair.tparams if which == "adapter" else pair.tmerged
    tkernels.reset_launches()
    r_logits, _, r_step = _ref_prefill_decode(pair, rparams)
    t_logits, t_step = _port_prefill_decode(pair, tparams)
    assert set(tkernels.launches().values()) == {0}
    np.testing.assert_allclose(t_logits, r_logits, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_step, r_step, atol=TOL, rtol=0)


@pytest.mark.parametrize("scheme", ("intq", "qalora"))
def test_cuda_tensors_always_take_the_kernels(monkeypatch, scheme):
    """The kernel wrappers are the only route: a CUDA tensor goes to them
    even under the reference's default ``use_kernel=False``."""
    from repro_torch.kernels import ops
    calls = []
    monkeypatch.setattr(ops, "qmatmul",
                        lambda x, qt: calls.append("qmatmul"))
    monkeypatch.setattr(ops, "qalora_matmul",
                        lambda x, qt, p, s: calls.append("qalora_matmul"))
    pol = TS.QuantPolicy(mode=scheme, bits=4, group_size=16, rank=2)
    assert not pol.use_kernel
    lp = TS.linear_init(torch.Generator().manual_seed(0), 32, 8, pol,
                        device="cpu")
    TS.linear_apply(lp, SimpleNamespace(device=torch.device("cuda")))
    assert calls == ["qmatmul" if scheme == "intq" else "qalora_matmul"]


def test_greedy_tokens_identical_to_reference_generate(pair):
    toks = jnp.asarray(pair.prompts)
    logits, pre = jax.jit(pair.rlm.prefill)(pair.merged, {"tokens": toks})
    cache = pair.rlm.merge_prefill_cache(
        pre, pair.rlm.init_cache(toks.shape[0], pair.max_len,
                                 dtype=jnp.float32))
    r_gen, _ = pair.rlm.generate(pair.merged, cache, logits, GEN_LEN)
    t_gen, times = tserve.generate(pair.tlm, pair.tmerged, pair.prompts,
                                   GEN_LEN, pair.max_len, device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))
    assert t_gen.shape == (2, GEN_LEN) and times["total_s"] > 0


def test_loop_reference_identical_to_prefill_generate(pair):
    t_gen, _ = tserve.generate(pair.tlm, pair.tmerged, pair.prompts, GEN_LEN,
                               pair.max_len, device="cpu")
    t_loop, _ = tserve.generate_loop_reference(
        pair.tlm, pair.tmerged, pair.prompts, GEN_LEN, pair.max_len,
        device="cpu")
    np.testing.assert_array_equal(t_loop, t_gen)


def test_bridge_keeps_storage_and_tags(pair):
    lp = pair.tparams.blocks[1]["mlp"]["down"]
    ref_lp = pair.params["blocks"]["mlp"]["down"]
    assert lp.scheme == "qalora" and lp.policy.s == ref_lp.policy.s
    np.testing.assert_array_equal(
        TS.quantized_base(lp).qweight.numpy(),
        np.asarray(RS.quantized_base(ref_lp).qweight)[1])
    merged = pair.tmerged.blocks[0]["attn"]["wq"]
    assert merged.scheme == "intq"
    assert pair.tparams.head.scheme == "fp"


def test_port_merge_matches_reference_merge(pair):
    """The port's own merge_tree of the adapter model gives the reference's
    merged codes and scales exactly, and its zeros within 1e-6 relative."""
    port_merged = tserve.merge_model(pair.tparams)
    for layer in range(pair.tcfg.n_layers):
        for path in (("attn", "wq"), ("mlp", "up")):
            lp = port_merged.blocks[layer][path[0]][path[1]]
            ref = RS.quantized_base(pair.merged["blocks"][path[0]][path[1]])
            qt = TS.quantized_base(lp)
            np.testing.assert_array_equal(qt.qweight.numpy(),
                                          np.asarray(ref.qweight)[layer])
            np.testing.assert_array_equal(qt.scale.numpy(),
                                          np.asarray(ref.scale)[layer])
            np.testing.assert_allclose(qt.zero.numpy(),
                                       np.asarray(ref.zero)[layer],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("argv", (
    ["--arch", "gemma3-1b", "--requests", "2", "--prompt-len", "8",
     "--gen-len", "4"],
    ["--arch", "llama7b-proxy", "--requests", "2", "--prompt-len", "0",
     "--gen-len", "3", "--policy", "*=int4,*/attn/wo=int8"],
))
def test_serve_cli_cpu(argv):
    out = tserve.main(argv + ["--device", "cpu", "--reduced", "--verify"])
    assert out["tokens"].shape[0] == 2
    for r in out["merge_check"].values():
        assert r["rel"] <= out["merge_bound_rel"]


@pytest.mark.parametrize("flag", (["--engine", "frontend"],
                                  ["--engine", "continuous", "--page-size",
                                   "16"],
                                  ["--speculate", "2"], ["--page-size", "4"]))
def test_serve_cli_refuses_modes_not_ported(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu"] + flag)
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    cfg = TC.reduced("llama7b-proxy")
    with pytest.raises(RuntimeError, match="cuda"):
        TLM(cfg).init_cache(1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--reduced"])


def test_policy_tree_resolution():
    base = TS.QuantPolicy(bits=4)
    tree = TS.PolicyTree.parse("*=int4,*/attn/wo=int8,lm_head=fp", base=base)
    assert TS.resolve_path(tree, "blocks/attn/wo").bits == 8
    assert TS.resolve_path(tree, "blocks/mlp/up").bits == 4
    assert TS.resolve_path(tree, "lm_head").mode == "fp"
    star = TS.PolicyTree.parse("*=intq4", base=base)
    assert TS.resolve_path(star, "lm_head").mode == "fp"  # head exemption
    assert TS.resolve_path(base, "lm_head").mode == "fp"
    assert TS.resolve_path(tree, "blocks/attn/wo") == dataclasses.replace(
        base, mode="qalora", bits=8)
