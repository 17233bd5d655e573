"""Parity of the port's other gqa configs (h2o-danube-1.8b, starcoder2-7b,
deepseek-67b) and of the gqa_moe family (mixtral-8x22b) with the JAX
package, on the CPU at ``reduced()`` sizes in f32: configs, prefill
logits, static greedy tokens, the continuous engine's streams
(contiguous and paged; for mixtral at two chunk and burst settings, batch
for batch, since capacity routing makes a token's experts depend on the
rest of its batch), the merge check, the tenants' refusal, and the
captures of mixtral's serve steps within their budgets.

The reference tree from ``LM.init`` (adapters nudged by +0.01, as its
serve CLI nudges them) goes to the port through numpy and
``repro_torch.bridge``; the reference runs without a mesh.
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
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, serving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from _torch_parity import bump, numpy_tree  # noqa: E402

DENSE = ("h2o-danube-1.8b", "starcoder2-7b", "deepseek-67b")
MOE = "mixtral-8x22b"
TOL = 1e-5
PROMPT = 32  # two routing chunks of the reduced moe_chunk 16
GEN_LEN = 5


@pytest.fixture(scope="module", params=DENSE + (MOE,))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def moe():
    return _pair(MOE)


def _pair(arch):
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    params = bump(rlm.init(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg),
        params=params, merged=merged,
        tparams=bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        prompts=np.random.default_rng(0).integers(
            4, rcfg.vocab, size=(2, PROMPT)).astype(np.int32))


@pytest.mark.parametrize("arch", DENSE + (MOE,))
def test_config_matches_reference(arch):
    """Every field the port's ArchConfig has equals the reference's, in
    the full and the reduced config; the policy's numbers too."""
    fields = [f.name for f in dataclasses.fields(TC.ArchConfig)
              if f.name != "quant"]
    for r, t in ((RC.get(arch), TC.get(arch)),
                 (RC.reduced(arch), TC.reduced(arch))):
        for name in fields:
            assert getattr(t, name) == getattr(r, name), (arch, name)
        for name in ("mode", "bits", "group_size", "rank", "s"):
            assert getattr(t.quant, name) == getattr(r.quant, name), name


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_logits_match_reference(pair, which):
    """Last-token prefill logits within 1e-5 of ``jax.jit(lm.prefill)``
    at a prompt of 32 (mixtral: two routing chunks), and the prefill
    caches equal."""
    rp = pair.params if which == "adapter" else pair.merged
    tp = pair.tparams if which == "adapter" else pair.tmerged
    r_logits, r_cache = jax.jit(pair.rlm.prefill)(
        rp, {"tokens": jnp.asarray(pair.prompts)})
    with torch.no_grad():
        t_logits, t_cache = pair.tlm.prefill(
            tp, {"tokens": torch.from_numpy(pair.prompts)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=TOL, rtol=0)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            t_cache["layers"][leaf].numpy(),
            np.asarray(r_cache["layers"][leaf]), atol=TOL, rtol=0)


def test_greedy_tokens_identical_to_reference_generate(pair):
    """The static path (prefill, merge into the decode cache, greedy
    decode through the port's generator) gives the reference's
    ``LM.generate`` tokens on the merged tree."""
    toks = jnp.asarray(pair.prompts)
    max_len = PROMPT + GEN_LEN
    logits, pre = jax.jit(pair.rlm.prefill)(pair.merged, {"tokens": toks})
    cache = pair.rlm.merge_prefill_cache(
        pre, pair.rlm.init_cache(2, max_len, dtype=jnp.float32))
    r_gen, _ = pair.rlm.generate(pair.merged, cache, logits, GEN_LEN)
    t_gen, _ = tserve.generate(pair.tlm, pair.tmerged, pair.prompts,
                               GEN_LEN, max_len, device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))


def _serve(mod, lm, tree, trace, **kw):
    eng = mod.ContinuousEngine(lm, tree, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng, eng.run()


ENGINE_SETTINGS = {
    "2slots-chunk4-burst2": dict(n_slots=2, max_len=16, prefill_chunk=4,
                                 decode_burst=2),
    "3slots-chunk4-burst4": dict(n_slots=3, max_len=24, prefill_chunk=4,
                                 decode_burst=4)}
TRACES = {
    "2slots-chunk4-burst2": dict(n=5, seed=2, prompt_lens=(2, 5),
                                 gen_lens=(2, 3)),
    "3slots-chunk4-burst4": dict(n=7, seed=3, prompt_lens=(3, 6, 11),
                                 gen_lens=(2, 9, 4))}


def _trace(name, vocab):
    t = dict(TRACES[name])
    return serving.make_trace(t.pop("n"), vocab, **t)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_streams_match_reference(arch):
    """A mixed trace with more requests than slots through the port's
    continuous engine, contiguous and paged: the reference
    ``ContinuousEngine``'s streams (no mesh)."""
    p = _pair(arch)
    name = "3slots-chunk4-burst4"
    trace = _trace(name, p.rcfg.vocab)
    kw = ENGINE_SETTINGS[name]
    _, ref = _serve(rserving, p.rlm, p.merged, trace, **kw)
    _, cont = _serve(serving, p.tlm, p.tmerged, trace, **kw)
    _, paged = _serve(serving, p.tlm, p.tmerged, trace, page_size=4, **kw)
    assert cont == ref and paged == ref


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("setting", tuple(ENGINE_SETTINGS))
def test_moe_engine_streams_match_reference(moe, setting, layout):
    """mixtral's streams through the port's engine equal the reference
    engine's on the same trace, slots, chunk and burst (capacity routing
    is batch for batch, padding rows included); the runs drop assignments
    at capacity, so the drops are held too, and the paged pool drains."""
    from repro_torch.models.moe import record_routing
    trace = _trace(setting, moe.rcfg.vocab)
    kw = dict(ENGINE_SETTINGS[setting])
    if layout == "paged":
        kw.update(page_size=4,
                  n_pages=12 if setting.startswith("2slots") else None)
    reng, ref = _serve(rserving, moe.rlm, moe.merged, trace, **kw)
    with record_routing() as rec:
        eng, got = _serve(serving, moe.tlm, moe.tmerged, trace, **kw)
    assert got == ref
    assert sum(int((~r["keep"]).sum()) for r in rec) > 0
    if layout == "paged":
        eng.page_table.check_invariants()
        assert eng.page_table.n_used == 0
        assert eng.page_table.peak_used == reng.page_table.peak_used


def test_moe_merge_within_bound(moe):
    """The port's merge check on mixtral: the unmerged (qalora) and merged
    (intq) models route every token alike in f32, and every token's
    logits are within ``merge_bound``; the prefill is compared at every
    position."""
    res = tserve.merge_check(moe.tlm, moe.tparams, moe.tmerged, moe.prompts,
                             PROMPT + 1, device="cpu")
    bound = tserve.merge_bound(moe.tcfg)
    assert res["prefill"]["tokens"] == moe.prompts.size
    for r in res.values():
        assert r["flip_share"] == 0.0 and r["max_flipped_rel"] is None
        assert r["agreeing_tokens"] == r["tokens"]
        assert r["rel"] <= bound


def test_routing_agreement_and_compare_routed():
    """A flipped (token, layer) routing drops the token from the bound's
    tokens; the flip share and the flipped token's gap are reported; an
    order swap of the top-k is no flip."""
    idx = torch.tensor([[[0, 1], [2, 3]]])
    keep = torch.ones_like(idx, dtype=torch.bool)
    a = [{"idx": idx, "keep": keep}, {"idx": idx, "keep": keep}]
    b = [{"idx": idx.flip(-1), "keep": keep},
         {"idx": torch.tensor([[[0, 1], [2, 0]]]), "keep": keep}]
    same = tserve.routing_agreement(a, b)
    assert same.tolist() == [[[True, True]], [[True, False]]]
    ref = torch.zeros((1, 2, 3))
    ref[0, 0, 1] = 10.0
    got = ref.clone()
    got[0, 0, 0], got[0, 1, 2] = 0.01, 5.0
    r = tserve.compare_routed(got, ref, same)
    assert r["agreeing_tokens"] == 1 and r["tokens"] == 2
    assert r["flip_share"] == 0.25
    assert r["rel"] == pytest.approx(0.001)
    assert r["max_flipped_rel"] == pytest.approx(0.5)


@pytest.mark.parametrize("kw", (dict(speculate=1, drafter="*=intq8",
                                     decode_burst=1),
                                dict(adapters=object())))
def test_moe_tenants_and_speculation_are_refused(moe, kw):
    """Tenants over the experts stay refused, naming the reason (a
    capacity buffer's rows carry no slot id, in the reference too): the
    engine raises, and so does the serve CLI.  Speculation is served: the
    engine builds its drafter and the CLI runs (tests/test_torch_spec.py
    holds its streams to the reference's)."""
    flag = (["--speculate", "1"] if "speculate" in kw
            else ["--adapters", "a=demo:1"])
    argv = ["--arch", MOE, "--reduced", "--device", "cpu", "--engine",
            "continuous", "--requests", "2", "--prompt-len", "4",
            "--gen-len", "3", *flag]
    if "speculate" in kw:
        eng = serving.ContinuousEngine(moe.tlm, moe.tmerged, n_slots=2,
                                       max_len=16, **kw)
        assert eng.speculate == 1 and eng.draft_params is not None
        assert tserve.main(argv)["proposed_tokens"] > 0
        return
    with pytest.raises(NotImplementedError, match="no slot id.*per-row ids"):
        serving.ContinuousEngine(moe.tlm, moe.tmerged, n_slots=2,
                                 max_len=16, **kw)
    with pytest.raises(SystemExit):
        tserve.main(argv)


def _replay_by_call(fn, pool):
    """Stand-in capture: the replay calls the step again."""
    return fn


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_moe_engine_captures_within_budget(moe, layout):
    """Under a ``CompileGuard`` with a stand-in capture, mixtral's engine
    captures the ragged step once and the burst ladder within its budget,
    as a dense model's does (no extra capture for the MoE), keeps its
    cache at its addresses, and gives the eager engine's streams."""
    name = "3slots-chunk4-burst4"
    trace = _trace(name, moe.rcfg.vocab)
    kw = dict(ENGINE_SETTINGS[name],
              **({"page_size": 4} if layout == "paged" else {}))
    _, plain = _serve(serving, moe.tlm, moe.tmerged, trace, **kw)
    with port_guard.CompileGuard("moe engine") as guard:
        eng = serving.ContinuousEngine(moe.tlm, moe.tmerged, **kw)
        for g in eng.graphs.values():
            g.capture = _replay_by_call
        eng._declare_budgets()
        ptrs = [t.data_ptr() for t in eng.cache["layers"].values()]
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert eng.run() == plain
        counts = guard.counts()
        assert counts["engine.ragged"] == (1, 1)
        assert 1 <= counts["engine.burst"][0] <= counts["engine.burst"][1]
        assert ptrs == [t.data_ptr() for t in eng.cache["layers"].values()]
        guard.check()
    del eng


def test_moe_static_generator_captures_once(moe):
    """mixtral's static decode step under a stand-in capture: one capture
    within the generator's budget of 1, replayed after, tokens the
    reference ``LM.generate``'s."""
    max_len = PROMPT + GEN_LEN
    with port_guard.CompileGuard("moe generator") as guard:
        gen = tserve.make_graph_generator(moe.tlm, moe.tmerged,
                                          moe.prompts.shape, GEN_LEN,
                                          max_len, device="cpu")
        gen.graphs.capture = _replay_by_call
        got, _ = gen(moe.prompts)
        again, _ = gen(moe.prompts)
        guard.check()
    assert gen.graphs._cache_size() == 1
    toks = jnp.asarray(moe.prompts)
    logits, pre = jax.jit(moe.rlm.prefill)(moe.merged, {"tokens": toks})
    cache = moe.rlm.merge_prefill_cache(
        pre, moe.rlm.init_cache(2, max_len, dtype=jnp.float32))
    ref, _ = moe.rlm.generate(moe.merged, cache, logits, GEN_LEN)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("engine", ("static", "continuous"))
def test_serve_cli_serves_mixtral(engine):
    """``serve --arch mixtral-8x22b --reduced --device cpu --verify``: 4 +
    3 x 4 quantized linears a layer, the merge within its bound over
    every token (none flipped in f32)."""
    argv = ["--arch", MOE, "--reduced", "--device", "cpu", "--requests",
            "2", "--prompt-len", "8", "--gen-len", "4", "--verify",
            "--engine", engine]
    if engine == "continuous":
        argv += ["--slots", "2", "--page-size", "4"]
    res = tserve.main(argv)
    assert res["linears_per_layer"] == 16
    assert len(res["tokens"]) == 2
    for r in res["merge_check"].values():
        assert r["rel"] <= res["merge_bound_rel"]
        assert r["flip_share"] == 0.0
