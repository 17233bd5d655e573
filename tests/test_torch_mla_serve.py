"""Parity of the port's mla_moe serving (deepseek-v3-671b) with the JAX
package, on the CPU at ``reduced()`` sizes in f32, with no mesh: the
continuous engine, plain and with the MTP drafter (``speculate=1,
drafter="mtp"``), contiguous and paged, against the reference
``ContinuousEngine`` on one mixed trace (streams identical, proposed and
accepted drafts equal), with planted drafts so that some are accepted and
some rejected; the captured steps within their budgets; the serve CLI,
static and ``--engine continuous --speculate 1``, against the reference's
no-mesh paths; and the refusals.

A random MTP head rarely drafts the token the model emits, so the planted
runs overwrite the held drafts between dispatches, in both packages alike,
through each scheduler's ``set_spec_drafts``: half of them the plain
stream's next token, half another.

Paged, the reference differs from itself: its paged insert writes the
rows a slot does not consume (the padding rows of a ragged step) into the
null page, where the padding rows of other slots read them, and through
the experts' finite capacity those garbage rows change the routing of
real tokens, so its paged streams leave its contiguous ones on this
trace (ROADMAP.md, faults of the reference).  The port keeps the null
page as it is.  Its paged streams are held to the reference's contiguous
ones, and to the reference's paged ones with the null-page write undone.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, serving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from _torch_parity import bump, numpy_tree  # noqa: E402

ARCH = "deepseek-v3-671b"
# (prompt length, new tokens) of the mixed trace, on 2 slots
TRACE = ((5, 6), (9, 4), (3, 7), (12, 5), (6, 6), (7, 5))
ENGINE = dict(n_slots=2, max_len=24, prefill_chunk=4)
PAGE = 4
MTP = dict(speculate=1, drafter="mtp", decode_burst=1)
PLAIN = dict(decode_burst=2)


@pytest.fixture(scope="module")
def pair():
    rcfg, tcfg = RC.reduced(ARCH), TC.reduced(ARCH)
    rlm = RLM(rcfg)
    params = bump(jax.jit(rlm.init)(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    rng = np.random.default_rng(1)
    trace = [(rng.integers(4, rcfg.vocab, size=n).astype(np.int32), g)
             for n, g in TRACE]
    return SimpleNamespace(
        rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg), params=params,
        merged=merged, trace=trace,
        tparams=bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


def _plant(sched, plain, vocab):
    """Overwrite each held draft: the plain stream's next token where
    (rid + tokens emitted) is even, the token after it otherwise."""
    held = sched.spec_drafts()
    new = held.copy()
    for i, s in enumerate(sched.slots):
        if s is None or held[i] < 0:
            continue
        e, stream = len(s.emitted), plain[s.req.rid]
        if e < len(stream):
            right = stream[e]
            new[i] = right if (s.req.rid + e) % 2 == 0 else (right + 1) % vocab
    sched.set_spec_drafts(new)


def _serve(mod, lm, tree, trace, plant=None, **kw):
    """Every request of ``trace`` through one engine; returns (streams,
    proposed, accepted, the engine)."""
    eng = mod.ContinuousEngine(lm, tree, **ENGINE, **kw)
    for rid, (prompt, gen) in enumerate(trace):
        eng.submit(prompt, gen, rid=rid)
    while eng.sched.has_work:
        if plant is not None and eng.sched.all_decoding:
            _plant(eng.sched, plant, lm.cfg.vocab)
        eng.step_once()
    st = eng.stats
    return ({r: list(t) for r, t in eng.sched.outputs.items()},
            st.proposed_tokens, st.accepted_tokens, eng)


@pytest.fixture(scope="module")
def ref_runs(pair):
    """The reference's contiguous runs: plain, MTP, and MTP planted from
    the plain streams."""
    run = {name: _serve(rserving, pair.rlm, pair.merged, pair.trace, **kw)
           for name, kw in (("plain", PLAIN), ("mtp", MTP))}
    run["planted"] = _serve(rserving, pair.rlm, pair.merged, pair.trace,
                            plant=run["plain"][0], **MTP)
    return run


@pytest.mark.parametrize("mode", ("plain", "mtp"))
def test_engine_matches_reference(pair, ref_runs, mode):
    """Contiguous: the port's streams equal the reference's, and so do the
    proposed and accepted drafts (MTP: every decode dispatch after the
    first proposes one draft a slot)."""
    kw = PLAIN if mode == "plain" else MTP
    got = _serve(serving, pair.tlm, pair.tmerged, pair.trace, **kw)
    want = ref_runs[mode]
    assert got[0] == want[0]
    assert got[1:3] == want[1:3]
    assert (got[1] > 0) == (mode == "mtp")


def test_planted_drafts_accept_and_reject_as_the_reference(pair, ref_runs):
    """Drafts planted alike in both packages: streams, proposed and
    accepted counts equal, at least one draft accepted and one rejected,
    and every request its full count of tokens."""
    plain = ref_runs["plain"][0]
    got = _serve(serving, pair.tlm, pair.tmerged, pair.trace, plant=plain,
                 **MTP)
    want = ref_runs["planted"]
    assert got[0] == want[0]
    assert got[1:3] == want[1:3]
    proposed, accepted = got[1:3]
    assert 0 < accepted < proposed
    assert sum(len(t) for t in got[0].values()) == sum(g for _, g in TRACE)


@pytest.fixture
def null_page_kept(monkeypatch):
    """The reference's paged insert with its write into the null page
    undone (jit caches cleared around it, so no program keeps the other
    one)."""
    orig = RA._insert_tokens_paged

    def kept(pool, new, cur_len, n_new, pages):
        return orig(pool, new, cur_len, n_new, pages).at[0, 0].set(pool[0, 0])
    jax.clear_caches()
    monkeypatch.setattr(RA, "_insert_tokens_paged", kept)
    yield
    monkeypatch.setattr(RA, "_insert_tokens_paged", orig)
    jax.clear_caches()


@pytest.mark.parametrize("mode", ("plain", "mtp"))
def test_paged_engine_matches_reference(pair, ref_runs, mode):
    """Pages of 4: the port's paged streams equal its contiguous ones and
    the reference's contiguous ones (counts too), while the reference's
    own paged engine leaves them (the null-page fault: see the module
    docstring)."""
    kw = PLAIN if mode == "plain" else MTP
    got = _serve(serving, pair.tlm, pair.tmerged, pair.trace,
                 page_size=PAGE, **kw)
    want = ref_runs[mode]
    assert got[0] == want[0]
    assert got[1:3] == want[1:3]
    faulty = _serve(rserving, pair.rlm, pair.merged, pair.trace,
                    page_size=PAGE, **kw)
    assert faulty[0] != want[0]


@pytest.mark.parametrize("mode", ("plain", "mtp", "planted"))
def test_paged_engine_matches_reference_with_null_page_kept(
        pair, ref_runs, null_page_kept, mode):
    """The reference's paged engine with its null-page write undone gives
    the port's paged streams and counts, plain, MTP and planted."""
    kw = PLAIN if mode == "plain" else MTP
    plant = ref_runs["plain"][0] if mode == "planted" else None
    got = _serve(serving, pair.tlm, pair.tmerged, pair.trace, plant=plant,
                 page_size=PAGE, **kw)
    want = _serve(rserving, pair.rlm, pair.merged, pair.trace, plant=plant,
                  page_size=PAGE, **kw)
    assert got[0] == want[0]
    assert got[1:3] == want[1:3]


def test_mtp_steps_captured_within_budget(pair):
    """On a stand-in capture (the replay calls the step again), the MTP
    engine captures one ragged step and one MTP step, within the budgets
    it declares under the port's compile guard, and serves the streams of
    its eager run; the absorbed weights are made once, at construction."""
    eager = _serve(serving, pair.tlm, pair.tmerged, pair.trace, **MTP)
    calls = []
    orig = pair.tlm.absorbed_weights

    def counted(params):
        calls.append(1)
        return orig(params)
    object.__setattr__(pair.tlm, "absorbed_weights", counted)
    try:
        with port_guard.CompileGuard("mtp") as guard:
            eng = serving.ContinuousEngine(pair.tlm, pair.tmerged, **ENGINE,
                                           **MTP)
            for g in eng.graphs.values():
                g.capture = lambda fn, pool: fn
            eng._declare_budgets()
            for rid, (prompt, gen) in enumerate(pair.trace):
                eng.submit(prompt, gen, rid=rid)
            out = eng.run()
            guard.check()
    finally:
        object.__delattr__(pair.tlm, "absorbed_weights")
    assert {r: list(t) for r, t in out.items()} == eager[0]
    assert eng.budgets == {"engine.ragged": 1, "engine.spec_mtp": 1}
    assert {n: g._cache_size() for n, g in eng.graphs.items()} == \
        {"ragged": 1, "spec_mtp": 1}
    assert len(calls) == 1


def test_engine_refusals(pair):
    """``drafter="mtp"`` needs mla_moe with its head and k = 1 (the
    reference's reasons, in both packages); tenants over mla_moe are
    refused (its absorbed weights come from one fixed tree)."""
    for mod, lm, tree in ((rserving, pair.rlm, pair.merged),
                          (serving, pair.tlm, pair.tmerged)):
        with pytest.raises(ValueError, match="exactly ONE token"):
            mod.ContinuousEngine(lm, tree, **ENGINE, speculate=2,
                                 drafter="mtp", decode_burst=1)
    with pytest.raises(NotImplementedError, match="absorbed weights"):
        serving.ContinuousEngine(pair.tlm, pair.tmerged, **ENGINE,
                                 adapters=serving.AdapterStore(pair.tmerged,
                                                               capacity=2))
    cfg = TC.reduced(ARCH, mtp=False)
    lm = TLM(cfg)
    tree = lm.init(torch.Generator().manual_seed(0), "cpu")
    assert not hasattr(tree, "mtp_block")
    with pytest.raises(ValueError, match="mtp_block absent"):
        serving.ContinuousEngine(lm, tree, **ENGINE, **MTP)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
       "--prompt-len", "6", "--gen-len", "5"]


def _cli_prompts(cfg):
    return np.random.default_rng(0).integers(
        4, cfg.vocab, size=(3, 6)).astype(np.int32)


@pytest.fixture
def reference_model(pair, monkeypatch):
    """The CLI serves the reference's tree (through the bridge) in place of
    its own seeded init."""
    monkeypatch.setattr(tserve, "build_model",
                        lambda cfg, device, seed=0, bump=True:
                        (pair.tlm, pair.tparams, pair.tmerged))


def test_serve_cli_static_matches_reference(pair, reference_model):
    """``serve --arch deepseek-v3-671b --reduced --device cpu --verify``:
    the reference's no-mesh prefill -> merge_prefill_cache -> generate
    tokens, 5 + 3 MLA and MLP linears a dense layer and 5 + 3 x 4 + 3 an
    MoE layer, and the merge within its bound over tokens routed alike
    (none flipped in f32)."""
    res = tserve.main(CLI + ["--verify"])
    prompts = _cli_prompts(pair.rcfg)
    rlm, max_len = pair.rlm, 6 + 5
    logits, pre = jax.jit(rlm.prefill)(pair.merged,
                                       {"tokens": jnp.asarray(prompts)})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(3, max_len, dtype=jnp.float32))
    want, _ = rlm.generate(pair.merged, cache, logits, 5)
    np.testing.assert_array_equal(res["tokens"], np.asarray(want))
    assert res["linears_per_step"] == 8 + 2 * 20
    for r in res["merge_check"].values():
        assert r["rel"] <= res["merge_bound_rel"]
        assert r["flip_share"] == 0.0


def test_serve_cli_mtp_matches_reference(pair, reference_model):
    """``serve ... --engine continuous --speculate 1`` drafts with the MTP
    head by default and gives the reference ``ContinuousEngine``'s
    streams and counts with ``drafter="mtp"`` (3 slots, chunks of 8)."""
    res = tserve.main(CLI + ["--engine", "continuous", "--speculate", "1"])
    assert res["drafter"] == "mtp"
    eng = rserving.ContinuousEngine(pair.rlm, pair.merged, n_slots=3,
                                    max_len=6 + 5 + 1, prefill_chunk=8,
                                    **MTP)
    rids = [eng.submit(p, 5) for p in _cli_prompts(pair.rcfg)]
    out = eng.run()
    np.testing.assert_array_equal(res["tokens"],
                                  np.asarray([out[r] for r in rids]))
    assert (res["proposed_tokens"], res["accepted_tokens"]) == \
        (eng.stats.proposed_tokens, eng.stats.accepted_tokens)


def test_serve_cli_refuses_tenants_and_a_bad_mtp(capsys):
    """``--adapters`` on deepseek-v3 is refused naming the absorbed
    weights, and ``--speculate 2`` with the MTP head with the reference's
    reason."""
    with pytest.raises(SystemExit):
        tserve.main(CLI + ["--engine", "continuous", "--adapters",
                           "a=demo:1"])
    assert "absorbed weights" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(CLI + ["--engine", "continuous", "--speculate", "2"])
    assert "exactly ONE token ahead" in capsys.readouterr().err


def test_serve_cli_cuts_the_depth():
    """``serve --n-layers 2`` serves the first 2 layers (deepseek-v3: its
    1 dense layer and 1 MoE layer), as ``train --n-layers`` cuts them."""
    res = tserve.main(CLI + ["--n-layers", "2"])
    assert res["n_layers"] == 2
    assert res["linears_per_step"] == 8 + 20
    assert res["tokens"].shape == (3, 5)
