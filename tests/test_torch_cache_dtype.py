"""Parity of the continuous engine's ``cache_dtype`` with the JAX package,
on the CPU: ``ContinuousEngine(cache_dtype=torch.bfloat16)`` (contiguous,
paged, and self-speculating with an ``*=intq8`` drafter) against the
reference ``ContinuousEngine(cache_dtype=jnp.bfloat16)`` run with no
mesh, on reduced gemma3-1b and llama7b-proxy carried through the bridge
in f32; one ragged step's logits on a bf16 cache; ``ServingFrontend``
passing the dtype on, with a crash and a NaN poisoning recovered; the
captures of a bf16-cache engine within their budgets.

Bounds.  Both packages round the same f32 K/V rows to bf16 (round to
nearest even) and read them back in f32, so the logits agree as on an
f32 cache (1e-4, tests/test_torch_serve.py) unless a K/V element sits
within the f32 difference of a bf16 rounding boundary; such an element
moves by one bf16 step, 2^-8 of its size, and a logit by at most that
share of its own scale, so the bound is 1e-4 + 2^-8 max|logit|.  Against
the port's own f32 cache every element is rounded: the logits move by
at most ~2^-8 of their scale through each of the layers, and the bound
is 2^-6 max|logit| at the reduced sizes' two layers.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.launch.serve import merge_model  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import runtime as rruntime  # noqa: E402
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, runtime, serving  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from _torch_parity import numpy_tree  # noqa: E402

TOL = 1e-4
REF_REL = 2.0 ** -8   # one bf16 rounding step, against the reference
F32_REL = 2.0 ** -6   # every row rounded, against the port's f32 cache
ENGINE = dict(n_slots=3, max_len=27, prefill_chunk=4)
MODES = {"contiguous": dict(decode_burst=4),
         "paged": dict(decode_burst=4, page_size=4),
         "speculating": dict(decode_burst=1, speculate=3,
                             drafter="*=intq8"),
         "paged-speculating": dict(decode_burst=1, speculate=2,
                                   drafter="*=intq8", page_size=4)}


@pytest.fixture(scope="module", params=("gemma3-1b", "llama7b-proxy"))
def served(request):
    arch = request.param
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    merged = merge_model(rlm.init(jax.random.PRNGKey(0)), rcfg.quant)
    trace = serving.make_trace(7, rcfg.vocab, seed=3, prompt_lens=(3, 6, 11),
                               gen_lens=(2, 9, 4))
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, rlm=rlm, merged=merged, tlm=TLM(tcfg),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        trace=trace)


def _run(mod, lm, tree, trace, **kw):
    eng = mod.ContinuousEngine(lm, tree, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng, eng.run()


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_cache_engine_matches_reference(served, mode):
    """The same trace through both engines with bf16 caches: identical
    streams and counters; the target's (and the drafter's) K/V are
    bf16."""
    kw = dict(ENGINE, **MODES[mode])
    reng, ref = _run(rserving, served.rlm, served.merged, served.trace,
                     cache_dtype=jnp.bfloat16, **kw)
    eng, got = _run(serving, served.tlm, served.tmerged, served.trace,
                    cache_dtype=torch.bfloat16, **kw)
    assert got == ref
    assert (eng.stats.tokens_out, eng.stats.accepted_tokens) == (
        reng.stats.tokens_out, reng.stats.accepted_tokens)
    assert eng.cache_dtype == torch.bfloat16
    for cache in eng._caches():
        assert {t.dtype for t in cache["layers"].values()} == {
            torch.bfloat16}
    assert len(eng._caches()) == (2 if "speculate" in kw else 1)
    if "page_size" in kw:
        eng.page_table.check_invariants()


def _ragged_logits(served, page_size, r_dtype, t_dtype):
    """A prompt chunk, then one ragged step of a chunk and a decode row
    (one slot idle), on both packages' caches of the given dtypes; the
    second step's logits."""
    rng = np.random.default_rng(1)
    b, max_len = 3, 16
    chunk = rng.integers(4, served.rcfg.vocab, size=(b, 5)).astype(np.int32)
    step = rng.integers(4, served.rcfg.vocab, size=(b, 4)).astype(np.int32)
    rstate = served.rlm.slot_state(page_size, 13)
    tstate = served.tlm.slot_state(page_size, 13)
    rcache = rstate.init(b, max_len, dtype=r_dtype)
    tcache = tstate.init(b, max_len, dtype=t_dtype, device="cpu")
    if page_size:
        pages = np.asarray([[9, 2, 11, 5], [1, 4, 7, 12], [3, 6, 8, 10]],
                           np.int32)
        rcache["pages"] = jnp.asarray(pages)
        tcache["pages"].copy_(torch.from_numpy(pages))
    out = []
    for toks, n in ((chunk, [5, 3, 4]), (step, [4, 0, 1])):
        n = np.asarray(n, np.int32)
        r_logits, rcache = jax.jit(served.rlm.step_ragged)(
            served.merged, rcache, jnp.asarray(toks), jnp.asarray(n))
        t_logits, tcache = served.tlm.step_ragged(
            served.tmerged, tcache, torch.from_numpy(toks),
            torch.from_numpy(n))
        out = [np.asarray(r_logits), t_logits.numpy()]
    assert {t.dtype for t in tcache["layers"].values()} == {t_dtype}
    return out


@pytest.mark.parametrize("page_size", (0, 4), ids=("contiguous", "paged"))
def test_bf16_ragged_step_logits_within_bound(served, page_size):
    """One ragged step on a bf16 cache: within 1e-4 + 2^-8 max|logit| of
    the reference's on its bf16 cache, and within 2^-6 max|logit| of the
    port's on an f32 cache (see the module docstring)."""
    ref, got = _ragged_logits(served, page_size, jnp.bfloat16,
                              torch.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL + REF_REL * scale
    _, f32 = _ragged_logits(served, page_size, jnp.float32, torch.float32)
    assert np.abs(got - f32).max() <= F32_REL * np.abs(f32).max()


def _drain(mod, runtime_mod, lm, tree, trace, **kw):
    fe = mod.ServingFrontend(
        lm, tree, n_slots=2, max_len=24, prefill_chunk=4, decode_burst=2,
        queue_cap=len(trace),
        injector=runtime_mod.FaultInjector(seed=0, crash_steps=(3,),
                                           nan_steps=(6,)), **kw)
    for r in trace:
        fe.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id, rid=r.rid)
    fe.run_until_drained()
    return fe


@pytest.mark.parametrize("page_size", (0, 4), ids=("contiguous", "paged"))
def test_frontend_passes_a_bf16_cache_dtype_on(served, page_size):
    """``ServingFrontend(cache_dtype=bf16)`` serves through a crash and a
    NaN poisoning of its bf16 cache as the reference's does: every ticket
    equal, two recoveries each."""
    trace = serving.make_trace(6, served.rcfg.vocab, seed=3,
                               prompt_lens=(3, 5, 8), gen_lens=(4, 9, 6))
    kw = dict(page_size=page_size)
    ref = _drain(rserving, rruntime, served.rlm, served.merged, trace,
                 cache_dtype=jnp.bfloat16, **kw)
    fe = _drain(serving, runtime, served.tlm, served.tmerged, trace,
                cache_dtype=torch.bfloat16, **kw)
    assert fe.engine.cache["layers"]["k"].dtype == torch.bfloat16

    def tickets(f):
        return {t.rid: (t.status.name, list(t.tokens), t.n_recoveries)
                for t in f.tickets.values()}
    assert tickets(fe) == tickets(ref)
    assert fe.n_recoveries == ref.n_recoveries == 2
    assert all(t.status.name == "FINISHED" for t in fe.tickets.values())


@pytest.mark.parametrize("mode", ("contiguous", "speculating"))
def test_bf16_cache_engine_captures_within_budget(served, mode):
    """Under a ``CompileGuard`` with a stand-in capture, a bf16-cache
    engine's steps stay within their budgets, serve the eager streams, and
    keep their caches at their addresses through a reset."""
    kw = dict(ENGINE, cache_dtype=torch.bfloat16, **MODES[mode])
    _, eager = _run(serving, served.tlm, served.tmerged, served.trace,
                    **kw)
    with port_guard.CompileGuard("bf16 cache") as guard:
        eng = serving.ContinuousEngine(served.tlm, served.tmerged, **kw)
        for g in eng.graphs.values():
            g.capture = lambda fn, pool: fn
        eng._declare_budgets()
        ptrs = [t.data_ptr() for c in eng._caches()
                for t in c["layers"].values()]
        for r in served.trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert eng.run() == eager
        counts = guard.counts()
        for name, budget in eng.budgets.items():
            assert 1 <= counts[name][0] <= budget, (name, counts[name])
        eng.reset()
        assert ptrs == [t.data_ptr() for c in eng._caches()
                        for t in c["layers"].values()]
        guard.check()
    del eng
