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


@pytest.mark.parametrize("flag,message", (
    (["--page-size", "4"], "--page-size needs --engine continuous"),
    (["--speculate", "2"], "--speculate needs --engine continuous"),
    (["--engine", "continuous", "--inject-faults"],
     "--inject-faults needs --engine frontend"),
    (["--engine", "continuous", "--speculate", "2", "--decode-burst", "4"],
     "incompatible with --decode-burst > 1"),
    (["--engine", "continuous", "--page-size", "4", "--n-pages", "3"],
     "page pool can never cover"),
    (["--engine", "continuous", "--speculate", "1", "--draft-policy",
      "mtp"], "drafter='mtp' needs an mla_moe model")))
def test_serve_cli_refuses_modes_not_ported(flag, message, capsys):
    """What the CLI still refuses (paging and speculation are ported on
    the continuous engine and the frontend): paging or speculation on the
    static engine, injected faults without the frontend, speculation with
    decode bursts, a pool that can never hold a request, and the MTP
    drafter on a gqa model (the reference's reason: it needs mla_moe's MTP
    head)."""
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu"] + flag)
    assert message in capsys.readouterr().err


FRONTEND_ARGV = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                 "--requests", "6", "--slots", "2", "--prompt-len", "5",
                 "--gen-len", "6", "--prefill-chunk", "4"]


def _finished(res):
    return {i: t for i, (t, s) in enumerate(zip(res["tokens"],
                                                 res["ticket_status"]))
            if s == "FINISHED"}


def test_serve_cli_frontend_backpressure_names_the_depth(capsys):
    """``--queue-cap 4`` with 6 requests: the last two are REJECTED at
    submit time with the queue depth in the error; the rest finish."""
    res = tserve.main(FRONTEND_ARGV + ["--engine", "frontend",
                                       "--queue-cap", "4"])
    assert res["statuses"] == {"FINISHED": 4, "REJECTED": 2}
    assert res["ticket_status"][4:] == ["REJECTED", "REJECTED"]
    for err in res["ticket_errors"][4:]:
        assert "backpressure" in err and "depth 4/4" in err
    out = capsys.readouterr().out
    assert "depth 4/4" in out and "SLO: ttft" in out
    assert "0 recoveries" in out


def test_serve_cli_frontend_recovers_and_matches_continuous():
    """``--inject-faults``: at least one recovery (the crash at dispatch
    5), every request FINISHED, and the tokens ``--engine continuous``
    gives on the same prompts."""
    plain = tserve.main(FRONTEND_ARGV + ["--engine", "continuous"])
    res = tserve.main(FRONTEND_ARGV + ["--engine", "frontend",
                                       "--inject-faults"])
    assert res["recoveries"] >= 1
    assert (5, "crash") in res["injector_log"]
    assert all(e.startswith("InjectedFault") for e in res["fault_log"])
    assert res["statuses"] == {"FINISHED": 6}
    assert _finished(res) == {i: list(t) for i, t in
                              enumerate(plain["tokens"].tolist())}


@pytest.mark.parametrize("extra", (
    ["--adapters", "alice=demo:1,bob=demo:2", "--verify"],
    ["--page-size", "4", "--n-pages", "12"],
    ["--page-size", "4", "--speculate", "2", "--loop"]))
def test_serve_cli_frontend_takes_the_engine_modes(extra):
    """The frontend serves tenants, the paged cache (a pool under the
    contiguous capacity) and speculation, eager with ``--loop``, with the
    continuous engine's tokens."""
    plain = tserve.main(FRONTEND_ARGV + ["--engine", "continuous"] + extra)
    res = tserve.main(FRONTEND_ARGV + ["--engine", "frontend"] + extra)
    assert res["statuses"] == {"FINISHED": 6}
    assert _finished(res) == {i: list(t) for i, t in
                              enumerate(plain["tokens"].tolist())}
    if "--adapters" in extra:
        assert res["tenants"] == ["alice", "bob"]
        assert all(c["decode"]["rel"] <= res["merge_bound_rel"]
                   for c in res["tenant_check"].values())
    if "--page-size" in extra:
        assert res["page_size"] == 4 and 0 < res["peak_pages_used"] <= 11
    if "--loop" in extra:
        assert res["path"] == "eager" and res["proposed_tokens"] > 0


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
