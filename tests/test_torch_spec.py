"""Parity of the port's speculative decoding with the JAX package, on the
CPU: the accept-prefix rule (the reference's oracle properties, then the
reference's outputs on the same arrays), ``LM.verify_ragged`` against the
reference's under ``jax.jit`` with no mesh, and the speculating continuous
engine against the port's plain engine and the reference's
``ContinuousEngine(speculate=k, drafter=...)`` run with no mesh, on the
contiguous and the paged layouts; the knob conflicts; the CLI.

The acceptance oracle (as tests/test_speculative.py): a deterministic
``f(prefix) -> token`` stands in for the target's argmax, so the greedy
stream is computable directly and "whatever accept_drafts commits IS the
greedy stream's prefix" is checkable without a model.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback sweep (see _hypothesis_compat)
    from _hypothesis_compat import given, settings, strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.launch.serve import merge_model  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, serving  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from repro_torch.serving import accept_drafts, rollback_counts  # noqa: E402
from _torch_parity import numpy_tree  # noqa: E402

VOCAB = 8  # tiny: draft matches and EOS hits must both be likely
TOL = 1e-4  # logits, as tests/test_torch_serve.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _oracle(seed):
    """Deterministic target-argmax stand-in: token = hash(prefix)."""
    def f(prefix):
        h = seed
        for i, t in enumerate(prefix):
            h = (h * 1000003 + (i + 1) * (int(t) + 7)) % (2 ** 31)
        return h % VOCAB
    return f


def _greedy_stream(f, t0, n, remaining, eos):
    """Per-step greedy decode under the oracle, with the scheduler's
    termination rule (remaining cap, inclusive EOS)."""
    out, prefix = [], [t0]
    for _ in range(n):
        if len(out) >= remaining:
            break
        t = f(tuple(prefix))
        out.append(t)
        prefix.append(t)
        if eos >= 0 and t == eos:
            break
    return out


def _case(seed, B, K):
    """Drafts biased toward the oracle's continuation, the verify rows the
    oracle gives for them (garbage past n_new), and the slot state."""
    rng = np.random.default_rng(seed)
    f = _oracle(seed)
    t0 = rng.integers(0, VOCAB, size=B)
    n_new = np.where(rng.random(B) < 0.2, 0, rng.integers(1, K + 2, size=B))
    remaining = rng.integers(1, 7, size=B)
    eos = np.where(rng.random(B) < 0.5, -1, rng.integers(0, VOCAB, size=B))
    drafts = np.full((B, K), -1, np.int64)
    verify = np.full((B, K + 1), 777_777, np.int64)
    for b in range(B):
        prefix = [int(t0[b])]
        for i in range(max(int(n_new[b]) - 1, 0)):
            g = f(tuple(prefix))
            d = g if rng.random() < 0.6 else int(rng.integers(0, VOCAB))
            drafts[b, i] = d
            prefix.append(d)
        for i in range(int(n_new[b])):
            verify[b, i] = f((int(t0[b]), *map(int, drafts[b, :i])))
    return f, t0, drafts, verify, n_new, remaining, eos


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=60)
@given(seed=st.integers(0, 10 ** 6), B=st.integers(1, 4),
       K=st.integers(1, 4))
def test_accepted_run_is_exactly_the_greedy_stream(seed, B, K):
    """For every draft sequence, the port's ``accept_drafts`` commits the
    tokens per-step greedy decode would have emitted, maximal up to the
    remaining / EOS cuts, at least one for an active slot, none for an
    idle one, and m + rollback == n_new."""
    f, t0, drafts, verify, n_new, remaining, eos = _case(seed, B, K)
    emitted, m = accept_drafts(drafts, verify, n_new, remaining, eos)
    rb = rollback_counts(n_new, m)
    for b in range(B):
        if n_new[b] == 0:
            assert m[b] == 0 and (emitted[b] == -1).all()
            continue
        k = int(n_new[b]) - 1
        a = 0
        while a < k and drafts[b, a] == verify[b, a]:
            a += 1
        ref = _greedy_stream(f, int(t0[b]), a + 1, int(remaining[b]),
                             int(eos[b]))
        assert m[b] >= 1 and list(emitted[b, :m[b]]) == ref
        assert (emitted[b, m[b]:] == -1).all()
        assert len(ref) < a + 1 or m[b] == a + 1
        assert m[b] + rb[b] == n_new[b]
    assert (rb >= 0).all()


@settings(deadline=None, max_examples=30)
@given(seed=st.integers(0, 10 ** 6), K=st.integers(1, 4))
def test_all_drafts_from_the_oracle_accept_everything(seed, K):
    f = _oracle(seed)
    t0, prefix, drafts = 3, [3], []
    for _ in range(K):
        d = f(tuple(prefix))
        drafts.append(d)
        prefix.append(d)
    verify = [f((t0, *drafts[:i])) for i in range(K + 1)]
    emitted, m = accept_drafts(np.asarray([drafts]), np.asarray([verify]),
                               np.asarray([K + 1]), np.asarray([K + 9]),
                               np.asarray([-1]))
    assert m[0] == K + 1 and list(emitted[0]) == verify


@pytest.mark.parametrize("seed", range(8))
def test_accept_drafts_matches_reference(seed):
    """The same arrays through both packages: equal runs, counts and
    rollbacks."""
    _, _, drafts, verify, n_new, remaining, eos = _case(seed, 4, 3)
    got = accept_drafts(drafts, verify, n_new, remaining, eos)
    ref = rserving.accept_drafts(drafts, verify, n_new, remaining, eos)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(rollback_counts(n_new, got[1]),
                                  rserving.rollback_counts(n_new, ref[1]))


def test_acceptance_rule_errors_match_reference():
    for mod in (rserving, serving):
        with pytest.raises(ValueError, match="more rows than verified"):
            mod.rollback_counts(np.asarray([2]), np.asarray([3]))
        with pytest.raises(ValueError, match=r"drafts must be \[B, K\]"):
            mod.accept_drafts(np.zeros((2, 3)), np.zeros((2, 3)),
                              np.asarray([1, 1]), np.asarray([4, 4]),
                              np.asarray([-1, -1]))


# ---------------------------------------------------------------------------
# verify_ragged and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=("gemma3-1b", "llama7b-proxy"))
def served(request):
    arch = request.param
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    merged = merge_model(rlm.init(jax.random.PRNGKey(0)), rcfg.quant)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg),
        merged=merged,
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


@pytest.mark.parametrize("page_size", (0, 4))
def test_verify_ragged_matches_reference(served, page_size):
    """A prompt chunk, then one verify step of 4 positions (one slot idle
    at 0 rows, one at 2): logits at every consumed row within the port's
    step tolerance of the reference's ``verify_ragged`` under ``jax.jit``,
    no mesh; rows past n_new are not compared.  The cache advances by the
    full n_new on both sides."""
    rng = np.random.default_rng(1)
    b, max_len = 3, 16
    chunk = rng.integers(4, served.rcfg.vocab, size=(b, 5)).astype(np.int32)
    verify = rng.integers(4, served.rcfg.vocab, size=(b, 4)).astype(np.int32)
    rstate = served.rlm.slot_state(page_size, 13)
    tstate = served.tlm.slot_state(page_size, 13)
    rcache = rstate.init(b, max_len, dtype=jnp.float32)
    tcache = tstate.init(b, max_len, dtype=torch.float32, device="cpu")
    if page_size:
        pages = np.asarray([[9, 2, 11, 5], [1, 4, 7, 12], [3, 6, 8, 10]],
                           np.int32)
        rcache["pages"] = jnp.asarray(pages)
        tcache["pages"].copy_(_t(pages))
    n0 = np.asarray([5, 3, 4], np.int32)
    rcache = jax.jit(served.rlm.step_ragged)(
        served.merged, rcache, jnp.asarray(chunk), jnp.asarray(n0))[1]
    served.tlm.step_ragged(served.tmerged, tcache, _t(chunk), _t(n0))
    n_new = np.asarray([4, 0, 2], np.int32)
    r_logits, _, rcache = jax.jit(served.rlm.verify_ragged)(
        served.merged, rcache, jnp.asarray(verify), jnp.asarray(n_new))
    t_logits, _ = served.tlm.verify_ragged(served.tmerged, tcache,
                                           _t(verify), _t(n_new))
    assert tuple(t_logits.shape) == r_logits.shape == (b, 4,
                                                       served.rcfg.vocab)
    for i in range(b):
        np.testing.assert_allclose(t_logits[i, :n_new[i]].numpy(),
                                   np.asarray(r_logits)[i, :n_new[i]],
                                   atol=TOL, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(rcache["len"]))
    # verify's last consumed row is step_ragged's logits
    s_cache = tstate.init(b, max_len, dtype=torch.float32, device="cpu")
    if page_size:
        s_cache["pages"].copy_(tcache["pages"])
    served.tlm.step_ragged(served.tmerged, s_cache, _t(chunk), _t(n0))
    s_logits, _ = served.tlm.step_ragged(served.tmerged, s_cache,
                                         _t(verify), _t(n_new))
    np.testing.assert_array_equal(s_logits[0].numpy(),
                                  t_logits[0, 3].numpy())


def _run(mod, lm, tree, trace, **kw):
    eng = mod.ContinuousEngine(lm, tree, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng, eng.run()


def _mixed_trace(served):
    """More requests than slots, ragged prompt and gen lengths, and EOS
    live on two requests: each one's EOS is the third token it emits
    without one (the scheduler's inclusive-EOS rule then cuts it)."""
    if not hasattr(served, "trace"):
        trace = serving.make_trace(7, served.rcfg.vocab, seed=3,
                                   prompt_lens=(3, 6, 11),
                                   gen_lens=(2, 9, 4))
        _, free = _run(serving, served.tlm, served.tmerged, trace,
                       n_slots=3, max_len=27, prefill_chunk=4)
        for i in (1, 4):
            trace[i].eos_id = free[i][2]
        served.trace = trace
    return served.trace


@pytest.mark.parametrize("drafter,page_size", (("*=intq8", 0),
                                                ("*=intq8", 8),
                                                ("*=intq2", 0)))
def test_spec_engine_matches_plain_and_reference(served, drafter,
                                                 page_size):
    """Self-speculation (an 8-bit drafter, and a 2-bit one) gives the
    port's plain engine's streams and the reference speculating engine's
    (no mesh), contiguous and paged, through eviction, refill and EOS; the
    acceptance counts equal the reference's."""
    trace = _mixed_trace(served)
    kw = dict(n_slots=3, max_len=27, prefill_chunk=4, decode_burst=1)
    _, plain = _run(serving, served.tlm, served.tmerged, trace, **kw)
    spec_kw = dict(kw, speculate=3, drafter=drafter, page_size=page_size)
    reng, ref = _run(rserving, served.rlm, served.merged, trace, **spec_kw)
    eng, spec = _run(serving, served.tlm, served.tmerged, trace, **spec_kw)
    assert spec == plain == ref
    st, rst = eng.stats, reng.stats
    assert st.proposed_tokens > 0
    assert (st.proposed_tokens, st.accepted_tokens, st.tokens_out) == (
        rst.proposed_tokens, rst.accepted_tokens, rst.tokens_out)
    if drafter == "*=intq8":
        assert st.accepted_tokens > 0
    if page_size:
        eng.page_table.check_invariants()
        assert eng.page_table.n_used == 0


def test_stats_counters_on_a_hand_computed_perfect_trace(served):
    """Drafter = the target itself, so every draft is accepted.  One slot,
    prompt 2, gen 5, k = 2: the prefill emits token 1; round 1 (remaining
    4) commits 3; round 2 (remaining 1) proposes 2 and commits 1.  So
    proposed 4, accepted 2, tokens 5, acceptance 0.5."""
    eng = serving.ContinuousEngine(served.tlm, served.tmerged, n_slots=1,
                                   max_len=9, prefill_chunk=2,
                                   decode_burst=1, speculate=2,
                                   drafter=served.tmerged)
    prompt = np.asarray([5, 11], np.int32)
    rid = eng.submit(prompt, 5)
    out = eng.run()
    st = eng.stats
    assert (st.proposed_tokens, st.accepted_tokens, st.tokens_out) == (4, 2,
                                                                       5)
    assert st.acceptance_rate == pytest.approx(0.5)
    plain = serving.ContinuousEngine(served.tlm, served.tmerged, n_slots=1,
                                     max_len=9, prefill_chunk=2,
                                     decode_burst=1)
    rid_p = plain.submit(prompt, 5)
    assert plain.run()[rid_p] == out[rid]
    assert plain.stats.acceptance_rate == 0.0


def test_self_drafter_matches_reference_policy(served):
    """``make_self_drafter`` re-quantizes every linear of the merged tree
    at the policy's bits, with the codes the reference's gives."""
    from repro.core import schemes as RS
    from repro.serving.engine import make_self_drafter as ref_drafter
    got = serving.make_self_drafter(served.tmerged, "*=intq2",
                                    base=served.tlm.cfg.quant.default)
    ref = ref_drafter(served.merged, "*=intq2", base=served.rcfg.quant)
    lp, rlp = got.blocks[1]["mlp"]["down"], ref["blocks"]["mlp"]["down"]
    assert lp.scheme == rlp.scheme == "intq" and lp.policy.bits == 2
    np.testing.assert_array_equal(
        TS.quantized_base(lp).qweight.numpy(),
        np.asarray(RS.quantized_base(rlp).qweight)[1])
    assert got.embed is served.tmerged.embed   # what no policy covers


def test_spec_refusals_match_reference(served):
    """The knob conflicts raise as the reference's do: speculation with a
    burst, without a drafter, with an AdapterStore, a negative k, and a
    request whose speculative headroom the pool can never cover."""
    cases = (
        (dict(decode_burst=8, speculate=2, drafter="*=intq8"), ValueError,
         r"speculate=2 and decode_burst=8.*decode_burst=1 when speculating"),
        (dict(decode_burst=1, speculate=2), ValueError, "needs a drafter"),
        (dict(decode_burst=1, speculate=-1), ValueError, "speculate must"),
    )
    for mod, lm, tree in ((rserving, served.rlm, served.merged),
                          (serving, served.tlm, served.tmerged)):
        for kw, exc, match in cases:
            with pytest.raises(exc, match=match):
                mod.ContinuousEngine(lm, tree, n_slots=1, max_len=16, **kw)
        store = mod.AdapterStore(tree, capacity=2)
        with pytest.raises(NotImplementedError, match="AdapterStore"):
            mod.ContinuousEngine(lm, tree, n_slots=1, max_len=16,
                                 decode_burst=1, speculate=2,
                                 drafter="*=intq8", adapters=store)
        # 2 usable pages of 4 hold 8 positions: 5 + 2 fits, 5 + 2 + 2
        # speculative headroom does not
        eng = mod.ContinuousEngine(lm, tree, n_slots=1, max_len=16,
                                   decode_burst=1, speculate=2,
                                   drafter="*=intq8", page_size=4,
                                   n_pages=3)
        with pytest.raises(ValueError, match="2 speculative headroom.*pool"):
            eng.submit(np.arange(4, 9, dtype=np.int32), 2)
        eng.submit(np.arange(4, 8, dtype=np.int32), 2)
    with pytest.raises(NotImplementedError, match="mtp"):
        serving.ContinuousEngine(served.tlm, served.tmerged, n_slots=1,
                                 max_len=16, decode_burst=1, speculate=1,
                                 drafter="mtp")


def _stand_in(eng):
    """The engine's steps on a stand-in capture (the replay calls the step
    again) with their budgets declared, as on CUDA."""
    for g in eng.graphs.values():
        g.capture = lambda fn, pool: fn
    eng._declare_budgets()


@pytest.mark.parametrize("page_size", (0, 4))
def test_spec_engine_captures_within_budget(served, page_size):
    """Under a ``CompileGuard`` with a stand-in capture: the target's and
    the drafter's ragged steps (budget 2), one draft scan and one verify
    width; the streams are the plain engine's, and the caches keep their
    addresses through admissions, rollbacks and a reset."""
    trace = _mixed_trace(served)
    kw = dict(n_slots=3, max_len=27, prefill_chunk=4, decode_burst=1,
              page_size=page_size)
    _, plain = _run(serving, served.tlm, served.tmerged, trace, **kw)
    with port_guard.CompileGuard("spec") as guard:
        eng = serving.ContinuousEngine(served.tlm, served.tmerged,
                                       speculate=3, drafter="*=intq8", **kw)
        _stand_in(eng)
        ptrs = [t.data_ptr() for c in eng._caches()
                for t in (*c["layers"].values(), *c.values())
                if isinstance(t, torch.Tensor)]
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert eng.run() == plain
        counts = guard.counts()
        assert {k: counts[k] for k in ("engine.ragged", "engine.draft",
                                       "engine.verify")} == {
            "engine.ragged": (2, 2), "engine.draft": (1, 1),
            "engine.verify": (1, 1)}
        eng.reset()
        assert ptrs == [t.data_ptr() for c in eng._caches()
                        for t in (*c["layers"].values(), *c.values())
                        if isinstance(t, torch.Tensor)]
        guard.check()
    del eng


@pytest.mark.parametrize("extra", (["--speculate", "2", "--draft-policy",
                                    "*=intq8"],
                                   ["--speculate", "3", "--page-size", "4"]))
def test_serve_cli_speculative_gives_the_plain_tokens(extra):
    argv = ["--arch", "llama7b-proxy", "--reduced", "--device", "cpu",
            "--engine", "continuous", "--requests", "3", "--slots", "2",
            "--prompt-len", "6", "--gen-len", "7", "--prefill-chunk", "4",
            "--verify"]
    plain = tserve.main(argv)
    spec = tserve.main(argv + extra)
    np.testing.assert_array_equal(spec["tokens"], plain["tokens"])
    assert spec["drafter"] == "*=intq8" and spec["decode_burst"] == 1
    assert spec["proposed_tokens"] > 0
    assert set(spec["captures"]) >= {"engine.draft", "engine.verify"}
    for r in spec["merge_check"].values():
        assert r["rel"] <= spec["merge_bound_rel"]


# ---------------------------------------------------------------------------
# gqa_moe: self-speculation over the experts (reduced mixtral-8x22b)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_served():
    arch = "mixtral-8x22b"
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    merged = merge_model(rlm.init(jax.random.PRNGKey(0)), rcfg.quant)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg),
        merged=merged,
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


MOE_SPEC_TRACE = dict(seed=3, prompt_lens=(3, 6, 11), gen_lens=(2, 9, 4))
# 12 usable pages of 4 hold two requests' prompt, gen and headroom of 3
# at once, so admission backs off (the contiguous capacity is 21 + 1)
MOE_PAGED = dict(page_size=4, n_pages=13)


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("drafter", ("*=intq8", "*=intq2"))
def test_moe_spec_engine_matches_reference(moe_served, drafter, layout):
    """Self-speculation over the experts: a verify step routes B (k + 1)
    rows and each drafter step its own, so an MoE's speculating streams
    are the reference speculating engine's (no mesh), not the plain
    engine's (capacity makes a row's experts depend on its batch).
    Streams, proposed and accepted drafts, tokens out and the paged
    pool's backoffs equal the reference's; the pool drains."""
    s = moe_served
    trace = serving.make_trace(7, s.rcfg.vocab, **MOE_SPEC_TRACE)
    kw = dict(n_slots=3, max_len=27, prefill_chunk=4, decode_burst=1,
              speculate=3, drafter=drafter,
              **(MOE_PAGED if layout == "paged" else {}))
    reng, ref = _run(rserving, s.rlm, s.merged, trace, **kw)
    eng, got = _run(serving, s.tlm, s.tmerged, trace, **kw)
    assert got == ref
    st, rst = eng.stats, reng.stats
    assert st.proposed_tokens > 0
    assert (st.proposed_tokens, st.accepted_tokens, st.tokens_out) == (
        rst.proposed_tokens, rst.accepted_tokens, rst.tokens_out)
    if layout == "paged":
        assert eng.page_table.alloc_backoffs \
            == reng.page_table.alloc_backoffs > 0
        eng.page_table.check_invariants()
        assert eng.page_table.n_used == 0


def test_moe_self_drafter_converts_every_expert_and_keeps_the_router(
        moe_served):
    """``make_self_drafter`` over mixtral re-quantizes every expert's gate,
    up and down at the policy's bits with the reference's codes; the
    router stays an exempt fp linear."""
    from repro.core import schemes as RS
    from repro.serving.engine import make_self_drafter as ref_drafter
    s = moe_served
    got = serving.make_self_drafter(s.tmerged, "*=intq2",
                                    base=s.tlm.cfg.quant.default)
    ref = ref_drafter(s.merged, "*=intq2", base=s.rcfg.quant)
    for blk, served_blk in zip(got.blocks, s.tmerged.blocks):
        moe = blk["moe"]
        assert moe.router.scheme == "fp" and moe.router.exempt
        assert torch.equal(TS.dense_view(moe.router),
                           TS.dense_view(served_blk["moe"].router))
        for name in ("gate", "up", "down"):
            for lp in getattr(moe, name):
                assert lp.scheme == "intq" and lp.policy.bits == 2
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            TS.quantized_base(getattr(got.blocks[1]["moe"], name)[3])
            .qweight.numpy(),
            np.asarray(RS.quantized_base(ref["blocks"]["moe"][name])
                       .qweight)[1, 3])


@pytest.mark.parametrize("page_size", (0, 4))
def test_moe_spec_engine_captures_within_budget(moe_served, page_size):
    """mixtral's speculating engine under a ``CompileGuard`` with a
    stand-in capture: the speculating dense model's budgets (the ragged
    steps 2, one draft scan, one verify width), and the eager engine's
    streams."""
    s = moe_served
    trace = serving.make_trace(7, s.rcfg.vocab, **MOE_SPEC_TRACE)
    kw = dict(n_slots=3, max_len=27, prefill_chunk=4, decode_burst=1,
              page_size=page_size, speculate=3, drafter="*=intq8")
    _, eager = _run(serving, s.tlm, s.tmerged, trace, **kw)
    with port_guard.CompileGuard("moe spec") as guard:
        eng = serving.ContinuousEngine(s.tlm, s.tmerged, **kw)
        _stand_in(eng)
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert eng.run() == eager
        counts = guard.counts()
        assert {k: counts[k] for k in ("engine.ragged", "engine.draft",
                                       "engine.verify")} == {
            "engine.ragged": (2, 2), "engine.draft": (1, 1),
            "engine.verify": (1, 1)}
        guard.check()
    del eng


def test_serve_cli_speculates_mixtral():
    """``serve --arch mixtral-8x22b --speculate 3`` is accepted: drafts are
    proposed, and the tokens are the speculating engine's."""
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu",
            "--engine", "continuous", "--requests", "3", "--slots", "2",
            "--prompt-len", "6", "--gen-len", "7", "--prefill-chunk", "4",
            "--speculate", "3", "--draft-policy", "*=intq2"]
    spec = tserve.main(argv)
    assert spec["drafter"] == "*=intq2" and spec["decode_burst"] == 1
    assert spec["proposed_tokens"] > 0
    assert set(spec["captures"]) >= {"engine.draft", "engine.verify"}
    assert np.asarray(spec["tokens"]).shape == (3, 7)
