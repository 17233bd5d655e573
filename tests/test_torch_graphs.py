"""Compiled serve steps of the PyTorch port on the CPU, at reduced
gemma3-1b: the port's ``CompileGuard`` against the reference's, the step
graph cache (``repro_torch.runtime.graphs``) with a stand-in capture, the
in-place step bodies against the reference's no-mesh paths, and the
launch-count delta added on replay.

On the CPU a :class:`StepGraphs` runs its step directly.  A test that sets
``capture`` to a stand-in drives the graphed route's keying, warm-up and
budgets: ``lambda fn, pool: fn`` "captures" a step whose replay calls it
again, as a replayed CUDA graph re-runs the recorded kernels.
"""

import copy
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.runtime import compile_guard as ref_guard  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, kernels, serving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from _torch_parity import bump as _bump, numpy_tree as _numpy_tree  # noqa: E402

GUARDS = {"reference": ref_guard, "port": port_guard}


def replay_by_call(fn, pool):
    """Stand-in capture: the replay calls the step again."""
    return fn


def stand_in(eng):
    """Put the engine's steps on the stand-in capture and declare their
    budgets, as a CUDA engine does at construction (on the CPU the steps
    run eagerly and declare nothing)."""
    for g in eng.graphs.values():
        g.capture = replay_by_call
    eng._declare_budgets()


# ---------------------------------------------------------------------------
# CompileGuard: the port's copy against the reference's, the scenarios of
# tests/test_compile_guard.py
# ---------------------------------------------------------------------------


class FakeJit:
    """Duck-typed compiled program: just the ``_cache_size`` probe."""

    def __init__(self, n=0):
        self.n = n

    def _cache_size(self):
        return self.n

    def compile(self, k=1):
        self.n += k


def _within_budget(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=2)
    f.compile(2)
    g.check()
    assert g.counts() == {"prog": (2, 2)} and g.count("prog") == 2
    assert "prog: 2/2" in g.summary()


def _over_budget(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=1)
    f.compile(3)
    with pytest.raises(cg.CompileBudgetExceeded,
                       match=r"prog: 3 compiles > budget 1"):
        g.check()
    assert g.violations() == [("prog", 3, 1)]


def _baseline_snapshot(cg, monkeypatch):
    f, g = FakeJit(n=7), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=0)
    g.check()
    f.compile()
    with pytest.raises(cg.CompileBudgetExceeded):
        g.check()


def _redeclare_accumulates(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=2)
    f.compile(2)
    g.declare_jit("prog", f, budget=2)
    f.compile(2)
    g.check()
    f.compile()
    with pytest.raises(cg.CompileBudgetExceeded):
        g.check()


def _release_owner_bounded(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=2, owner="a")
    f.compile(4)
    g.declare_jit("prog", f, budget=2, owner="b")
    assert g.release_owner("b") == 1
    assert g.counts()["prog"] == (4, 2)
    with pytest.raises(cg.CompileBudgetExceeded):
        g.check()
    assert g.release_owner("a") == 1
    assert g.counts()["prog"] == (2, 0)
    assert g.release_owner("ghost") == 0


def _release_owner_churn(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    for owner in ("e1", "e2"):
        g.declare_jit("prog", f, budget=3, owner=owner)
        f.compile(3)
        g.check()
        g.release_owner(owner)
        assert g.counts()["prog"] == (0, 0)


def _ownerless_legacy(cg, monkeypatch):
    f, g = FakeJit(), cg.CompileGuard("t")
    g.declare_jit("prog", f, budget=1)
    g.declare_jit("prog", f, budget=1)
    assert g.release_owner("anything") == 0
    assert g.counts()["prog"] == (0, 2)


def _wrap_counter_pin(cg, monkeypatch):
    mod = types.SimpleNamespace(__name__="fakemod", helper=lambda x: x + 1)
    with cg.CompileGuard("t") as g:
        g.wrap_counter(mod, "helper", budget=0)
        g.check()
        assert mod.helper(1) == 2
        assert g.count("fakemod.helper") == 1
        with pytest.raises(cg.CompileBudgetExceeded, match="fakemod.helper"):
            g.check()
    assert not hasattr(mod.helper, "__wrapped__")


def _wrap_counter_rewrap(cg, monkeypatch):
    mod = types.SimpleNamespace(__name__="fakemod", helper=lambda x: x + 1)
    with cg.CompileGuard("t") as g:
        g.wrap_counter(mod, "helper", budget=1)
        g.wrap_counter(mod, "helper", budget=1)
        mod.helper(0)
        mod.helper(0)
        assert g.count("fakemod.helper") == 2
        g.check()
    assert not hasattr(mod.helper, "__wrapped__")


def _stack_innermost_wins(cg, monkeypatch):
    monkeypatch.delenv(cg.ENV_FLAG, raising=False)
    cg.reset_global()
    assert cg.current() is None
    with cg.CompileGuard("outer") as outer:
        assert cg.current() is outer
        with cg.CompileGuard("inner") as inner:
            assert cg.current() is inner
        assert cg.current() is outer
    assert cg.current() is None


def _env_var_ambient(cg, monkeypatch):
    monkeypatch.setenv(cg.ENV_FLAG, "1")
    cg.reset_global()
    try:
        assert cg.enabled()
        g = cg.current()
        assert g is not None and g is cg.current()
        with cg.CompileGuard("explicit") as e:
            assert cg.current() is e
        assert cg.current() is g
    finally:
        cg.reset_global()


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _within_budget, _over_budget, _baseline_snapshot, _redeclare_accumulates,
    _release_owner_bounded, _release_owner_churn, _ownerless_legacy,
    _wrap_counter_pin, _wrap_counter_rewrap, _stack_innermost_wins,
    _env_var_ambient)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("which", sorted(GUARDS))
def test_compile_guard_matches_reference(which, scenario, monkeypatch):
    """Every scenario of the reference's guard tests, run on both modules:
    the port's copy behaves as the reference's."""
    SCENARIOS[scenario](GUARDS[which], monkeypatch)


def test_port_guard_state_is_its_own(monkeypatch):
    """The two modules share the environment flag but no stack or ambient
    guard."""
    monkeypatch.delenv(port_guard.ENV_FLAG, raising=False)
    assert port_guard.ENV_FLAG == ref_guard.ENV_FLAG
    with ref_guard.CompileGuard("ref"):
        assert port_guard.current() is None
    with port_guard.CompileGuard("port") as g:
        assert port_guard.current() is g and ref_guard.current() is None


# ---------------------------------------------------------------------------
# the step graph cache
# ---------------------------------------------------------------------------


def test_step_graphs_run_directly_on_the_cpu_and_when_eager():
    for g in (graphs.StepGraphs("s", "cpu"),
              graphs.StepGraphs("s", "cpu", eager=True)):
        assert g.capture is None and g.pool is None
        calls = []
        for _ in range(3):
            assert g("k", lambda: calls.append(1) or len(calls)) == len(calls)
        assert len(calls) == 3 and g._cache_size() == 0


def test_step_graphs_capture_once_per_key_then_replay():
    """The first call of a key runs the step (its warm-up, whose result it
    returns) and captures it; later calls replay; a new key captures
    again; the process-wide probe counts every capture of the name."""
    g = graphs.StepGraphs("test.keys", "cpu")
    g.capture = replay_by_call
    probe = graphs.captures("test.keys")
    base = probe._cache_size()
    calls = []

    def step():
        calls.append(1)
        return len(calls)

    assert [g(("ragged", 4, 8), step) for _ in range(3)] == [1, 2, 3]
    assert g._cache_size() == 1 and probe._cache_size() == base + 1
    g(("ragged", 4, 2), step)          # a new chunk width
    g(("burst", 4), step)
    g(("burst", 2), step)              # a new k
    g(("burst", 4), step)
    assert g._cache_size() == 4 and probe._cache_size() == base + 4
    assert sorted(map(str, g.graphs)) == sorted(map(str, [
        ("ragged", 4, 8), ("ragged", 4, 2), ("burst", 4), ("burst", 2)]))


def test_failed_capture_raises_and_caches_nothing():
    g = graphs.StepGraphs("test.fail", "cpu")

    def broken(fn, pool):
        raise RuntimeError("capture failed")
    g.capture = broken
    calls = []
    with pytest.raises(RuntimeError, match="capture failed"):
        g("k", lambda: calls.append(1))
    assert calls == [1] and g._cache_size() == 0   # the warm-up ran once


def test_stage_copies_into_fixed_buffers():
    g = graphs.StepGraphs("test.stage", "cpu")
    a = g.stage("k", tokens=np.arange(6, dtype=np.int32).reshape(2, 3),
                n=np.ones(2, np.int32))
    b = g.stage("k", tokens=np.full((2, 3), 7, np.int32),
                n=np.zeros(2, np.int32))
    assert a["tokens"] is b["tokens"] and a["n"] is b["n"]
    assert b["tokens"].dtype == torch.int32
    assert (b["tokens"] == 7).all() and (b["n"] == 0).all()
    with pytest.raises(ValueError, match="its buffer"):
        g.stage("k", tokens=np.zeros((2, 4), np.int32))


def test_launch_count_delta_is_added_on_replay():
    """A replay runs no wrapper: what the capture counted is taken back and
    added again on every replay, so the counts equal the launches the card
    ran (the warm-up's and each replay's)."""
    kernels.reset_launches()
    kernels.add_launches({"qmatvec": 3, "qalora_slot_rank_proj": 1})
    assert kernels.launches()["qmatvec"] == 3
    kernels.add_launches({"qmatvec": -3, "qalora_slot_rank_proj": -1})
    assert set(kernels.launches().values()) == {0}

    def step():                       # what a wrapper does as it launches
        kernels.KERNELS["qmatvec"].launches += 2
        kernels.KERNELS["qalora_rank_proj"].launches += 1

    def record(fn, pool):             # a capture runs the Python once
        fn()
        return lambda: None           # and a replay runs none of it
    g = graphs.StepGraphs("test.counts", "cpu")
    g.capture = record
    g("k", step)                      # warm-up: counted
    assert kernels.launches()["qmatvec"] == 2    # the capture's taken back
    assert g.graphs["k"].launches == {"qmatvec": 2, "qalora_rank_proj": 1}
    for _ in range(4):
        g("k", step)
    counts = kernels.launches()
    kernels.reset_launches()
    assert counts["qmatvec"] == 2 * 5 and counts["qalora_rank_proj"] == 5
    assert sum(counts.values()) == 15


# ---------------------------------------------------------------------------
# in-place step bodies against the reference's no-mesh paths
# ---------------------------------------------------------------------------

GEN = 6


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = RC.reduced("gemma3-1b"), TC.reduced("gemma3-1b")
    rlm = RLM(rcfg)
    merged = RS.merge_tree(_bump(rlm.init(jax.random.PRNGKey(0))))
    return types.SimpleNamespace(
        rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg), merged=merged,
        tmerged=bridge.load_numpy_tree(_numpy_tree(merged), tcfg, "cpu"))


def _ref_generate(m, prompts, gen_len, max_len):
    toks = jnp.asarray(prompts)
    logits, pre = jax.jit(m.rlm.prefill)(m.merged, {"tokens": toks})
    cache = m.rlm.merge_prefill_cache(
        pre, m.rlm.init_cache(toks.shape[0], max_len, dtype=jnp.float32))
    out, _ = m.rlm.generate(m.merged, cache, logits, gen_len)
    return np.asarray(out)


@pytest.mark.parametrize("route", ("cpu", "stand-in capture", "eager"))
def test_generator_tokens_equal_reference_generate(model, route):
    """make_graph_generator, built once and called on two prompt batches of
    its shape, gives the reference's tokens; with a stand-in capture its
    decode step is captured once (the first call) and replayed after."""
    rng = np.random.default_rng(3)
    max_len = 8 + GEN
    with port_guard.CompileGuard("generator") as guard:
        gen = tserve.make_graph_generator(model.tlm, model.tmerged, (2, 8),
                                          GEN, max_len, device="cpu",
                                          eager=route == "eager")
    assert guard.counts() == {}     # built on a route that captures nothing
    if route == "stand-in capture":
        gen.graphs.capture = replay_by_call
    for _ in range(2):
        prompts = rng.integers(4, model.rcfg.vocab, size=(2, 8)) \
            .astype(np.int32)
        got, times = gen(prompts)
        np.testing.assert_array_equal(
            got, _ref_generate(model, prompts, GEN, max_len))
        assert got.shape == (2, GEN) and times["decode_s"] >= 0
    assert gen.graphs._cache_size() == (1 if route == "stand-in capture"
                                        else 0)
    with pytest.raises(ValueError, match="serves"):
        gen(np.zeros((3, 8), np.int32))


def test_captured_decode_step_refuses_another_weight_tree(model):
    """A captured decode step holds the weights it was captured with: a
    reused StepGraphs given the same cache and another params tree raises
    rather than replay the old weights; a new StepGraphs serves them."""
    lm = model.tlm
    cache = lm.init_cache(2, 8 + GEN, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.full((2, 8), 9, np.int32))
    decode = graphs.StepGraphs("test.decode", "cpu")
    decode.capture = replay_by_call
    logits, pre = lm.prefill(model.tmerged, {"tokens": toks})
    lm.merge_prefill_cache(pre, cache)
    first, _ = lm.generate(model.tmerged, cache, logits, GEN, graphs=decode)
    other = copy.copy(model.tmerged)          # the same weights, another tree
    lm.slot_state().clear(cache)
    lm.merge_prefill_cache(pre, cache)
    with pytest.raises(ValueError, match="captured with other objects"):
        lm.generate(other, cache, logits, GEN, graphs=decode)
    fresh = graphs.StepGraphs("test.decode", "cpu")
    fresh.capture = replay_by_call
    lm.slot_state().clear(cache)
    lm.merge_prefill_cache(pre, cache)
    again, _ = lm.generate(other, cache, logits, GEN, graphs=fresh)
    assert again.tolist() == first.tolist()


def test_step_ragged_writes_the_cache_in_place(model):
    """Lengths, K and V keep their addresses through prefill merge, ragged
    steps, reset and clear (a captured step reads them by address)."""
    lm = model.tlm
    st = lm.slot_state()
    cache = lm.init_cache(2, 12, dtype=torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in (*cache["layers"].values(), cache["len"])]
    toks = torch.from_numpy(np.full((2, 4), 7, np.int32))
    logits, pre = lm.prefill(model.tmerged, {"tokens": toks})
    assert lm.merge_prefill_cache(pre, cache) is cache
    lm.step_ragged(model.tmerged, cache, toks[:, :2],
                   torch.tensor([2, 1], dtype=torch.int32))
    assert cache["len"].tolist() == [6, 5]
    st.reset(cache, torch.tensor([False, True]))
    assert cache["len"].tolist() == [6, 0]
    st.clear(cache)
    assert not cache["layers"]["k"].any() and not cache["len"].any()
    assert ptrs == [t.data_ptr()
                    for t in (*cache["layers"].values(), cache["len"])]


def _trace(vocab):
    return serving.make_trace(5, vocab, seed=7, prompt_lens=(3, 9, 5),
                              gen_lens=(6, 3, 9))


@pytest.mark.parametrize("route", ("cpu", "stand-in capture", "eager"))
def test_engine_streams_equal_reference_loop_under_env_guard(
        model, route, monkeypatch):
    """REPRO_COMPILE_GUARD=1: the engine declares its capture budgets to
    the port's ambient guard when its steps are captured (never on the
    eager or CPU route) and checks them after every step; each request's
    stream equals the reference's per-token loop served alone."""
    monkeypatch.setenv(port_guard.ENV_FLAG, "1")
    port_guard.reset_global()
    try:
        eng = serving.ContinuousEngine(model.tlm, model.tmerged, n_slots=2,
                                       max_len=20, prefill_chunk=4,
                                       decode_burst=4,
                                       eager=route == "eager")
        guard = port_guard.current()
        if route == "stand-in capture":
            stand_in(eng)
            assert guard.counts()["engine.ragged"][1] == 1
            assert guard.counts()["engine.burst"][1] == 3   # k in {1, 2, 4}
        else:                       # nothing is captured, nothing declared
            assert guard.counts() == {}
        trace = _trace(model.rcfg.vocab)
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, rid=r.rid)
        out = eng.run()
        for r in trace:
            ref, _ = rserve.generate_loop_reference(
                model.rlm, model.merged, r.prompt[None], r.max_new_tokens,
                20)
            assert out[r.rid] == np.asarray(ref)[0].tolist(), r.rid
        captured = {g.name: g._cache_size() for g in eng.graphs.values()}
        if route == "stand-in capture":
            assert captured["engine.ragged"] == 1
            assert 1 <= captured["engine.burst"] <= 3
            assert guard.counts()["engine.ragged"][0] == 1
        else:
            assert set(captured.values()) == {0}
        guard.check()
    finally:
        port_guard.reset_global()


def test_one_capture_too_many_raises_naming_the_step(model):
    eng = None
    with port_guard.CompileGuard("budget") as guard:
        eng = serving.ContinuousEngine(model.tlm, model.tmerged, n_slots=2,
                                       max_len=16, prefill_chunk=4,
                                       decode_burst=2)
        stand_in(eng)
        eng.submit(np.arange(4, 10, dtype=np.int32), 3, rid=0)
        eng.step_once()                     # the ragged step: captured
        assert guard.counts()["engine.ragged"] == (1, 1)
        # a second chunk width would be a second capture
        eng.graphs["ragged"](("ragged", 2, 2), lambda: None)
        with pytest.raises(port_guard.CompileBudgetExceeded,
                           match=r"engine.ragged: 2 compiles > budget 1"):
            eng.step_once()
    del eng


# ---------------------------------------------------------------------------
# multi-tenant: mappings and registrations after capture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenants(model):
    """Two demo tenants over the reduced model, registered in a store of
    capacity 3."""
    params = model.tlm.init(torch.Generator().manual_seed(1), "cpu")
    tserve.bump_adapters(params)
    store, names = tserve.build_store(params, ["alpha=demo:1",
                                               "beta=demo:2"])
    return types.SimpleNamespace(params=params, store=store, names=names)


def test_new_mapping_and_late_tenant_do_not_recapture(model, tenants):
    """Captured steps read the engine's static ids buffer and the store's
    banks by address: a new slot -> adapter mapping and a tenant registered
    after the captures change neither address, need no capture, and serve
    the right tenant (its merged tree's stream)."""
    store = tenants.store
    eng = serving.ContinuousEngine(model.tlm, store.base, n_slots=2,
                                   max_len=20, prefill_chunk=4,
                                   decode_burst=4, adapters=store)
    stand_in(eng)
    prompt = np.arange(5, 12, dtype=np.int32)

    def serve(who):
        eng.submit(prompt, 5, rid=0, adapter_id=who[0])
        eng.submit(prompt[:5], 5, rid=1, adapter_id=who[1])
        out = eng.run()
        eng.reset()
        return out

    def merged(name, p):
        return tserve.generate(model.tlm, store.merged(name), p[None], 5, 20,
                               device="cpu")[0][0].tolist()

    first = serve(("alpha", "beta"))
    captured = {g.name: g._cache_size() for g in eng.graphs.values()}
    assert captured["engine.ragged"] == 1 and captured["engine.burst"] >= 1
    bank = next(iter(store._banks.values()))
    ptrs = (bank.a.data_ptr(), bank.b.data_ptr(), eng._slot_ids.data_ptr())
    swapped = serve(("beta", None))                 # a new mapping
    gamma = tserve.demo_tenant(tenants.params, 3)
    store.register("gamma", gamma)                  # a late tenant
    late = serve(("gamma", "alpha"))
    assert {g.name: g._cache_size() for g in eng.graphs.values()} == captured
    assert ptrs == (bank.a.data_ptr(), bank.b.data_ptr(),
                    eng._slot_ids.data_ptr())
    assert eng.params.blocks[0]["attn"]["wq"].data["ids"] is eng._slot_ids
    assert first[0] == merged("alpha", prompt)
    assert first[1] == merged("beta", prompt[:5])
    assert swapped[0] == merged("beta", prompt)
    assert swapped[1] == merged(None, prompt[:5])
    assert late[0] == merged("gamma", prompt)
    assert late[1] == merged("alpha", prompt[:5])


def test_with_slot_ids_writes_into_the_given_buffer(tenants):
    store = tenants.store
    out = torch.zeros(3, dtype=torch.int32)
    tree = store.with_slot_ids([1, 0, 2], out=out)
    assert out.tolist() == [1, 0, 2]
    assert tree.blocks[0]["mlp"]["down"].data["ids"] is out
    store.with_slot_ids([2, 2, 0], out=out)
    assert tree.blocks[0]["mlp"]["down"].data["ids"].tolist() == [2, 2, 0]
    with pytest.raises(ValueError, match="out must be int32"):
        store.with_slot_ids([1, 0], out=out)
    fresh = store.with_slot_ids([1, 0, 2])
    assert fresh.blocks[0]["mlp"]["down"].data["ids"] is not out


# ---------------------------------------------------------------------------
# the serve CLI's eager path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", (
    ["--requests", "2", "--prompt-len", "6", "--gen-len", "4"],
    ["--engine", "continuous", "--slots", "2", "--requests", "3",
     "--prompt-len", "5", "--gen-len", "4", "--adapters", "a=demo:1"],
))
def test_serve_loop_gives_the_graphed_paths_tokens(argv):
    base = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu"] + argv
    graphed, eager = (tserve.main(base + extra) for extra in ([],
                                                            ["--loop"]))
    np.testing.assert_array_equal(graphed["tokens"], eager["tokens"])
    assert eager["path"] == graphed["path"] == "eager"   # the CPU runs ops
    for res in (graphed, eager):
        assert all(c == 0 and b >= 1 for c, b in res["captures"].values())


def test_engine_reset_and_poison_keep_the_cache_addresses(model):
    eng = serving.ContinuousEngine(model.tlm, model.tmerged, n_slots=2,
                                   max_len=12, prefill_chunk=4)
    ptrs = [t.data_ptr() for t in (*eng.cache["layers"].values(),
                                   eng.cache["len"])]
    eng.submit(np.arange(4, 9, dtype=np.int32), 3)
    eng.step_once()
    eng.poison_cache()
    with pytest.raises(serving.EngineCorrupted):
        eng.step_once()
    eng.reset()
    assert not torch.isnan(eng.cache["layers"]["k"]).any()
    eng.submit(np.arange(4, 9, dtype=np.int32), 3, rid=5)
    assert len(eng.run()[5]) == 3
    assert ptrs == [t.data_ptr() for t in (*eng.cache["layers"].values(),
                                           eng.cache["len"])]


def test_graphs_module_imports_no_jax():
    import ast
    from pathlib import Path
    root = Path(graphs.__file__).parent
    for path in (root / "graphs.py", root / "compile_guard.py"):
        mods = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert not mods & {"jax", "repro"}, (path.name, mods)


def test_port_guard_exports_the_reference_names():
    assert sorted(port_guard.__all__) == sorted(ref_guard.__all__)
