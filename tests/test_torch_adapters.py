"""Parity of the port's multi-tenant serving slice with the JAX package, on
the CPU: the bank adapter delta, the slot GEMV kernel's plain version and
its large-M route, the scheduler and traces, the AdapterStore, and the
continuous engine serving several QA-LoRA tenants over one INT4 base.

Inputs and tenant noise are made with numpy from seeds and given to both
packages; trees go to the port through ``repro_torch.bridge``.  The
reference's Pallas kernels run in interpret mode, and its per-request
reference runs without a mesh (``jax.jit(lm.prefill)`` ->
``merge_prefill_cache`` -> ``LM.generate``).
"""

import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import qalora as rq  # noqa: E402
from repro.core import quant as rquant  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.qmatvec import qalora_slot_matvec_pallas  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, serving  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import qalora as tq  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.qmatvec import (qalora_slot_matvec_cuda,  # noqa: E402
                                         qalora_slot_matvec_plain,
                                         qmatvec_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import numpy_tree  # noqa: E402

BITS = (2, 3, 4, 8)
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bank_case(seed, bits, m, k=128, n=64, g=32, rank=4, n_bank=3):
    """A quantized base, banks (row 0 the null adapter), x and ids that
    include 0, as numpy."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = (rng.standard_normal((n_bank, k // g, rank)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_bank, rank, n)) * 0.3).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    ids = np.asarray([(i + 1) % n_bank for i in range(m)], np.int32)
    rqt = rquant.quantize(jnp.asarray(w), bits, g)
    tqt = tquant.quantize(_t(w), bits, g)
    return SimpleNamespace(x=x, a=a, b=b, ids=ids, rqt=rqt, tqt=tqt, g=g)


# ---------------------------------------------------------------------------
# bank_adapter_delta, the slot kernel's plain version, ops.qalora_slot_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank,l_groups,g,n_bank,lead", [
    (1, 1, 8, 1, (3,)), (4, 3, 16, 3, (5,)), (8, 4, 32, 5, (4, 3)),
    (16, 2, 32, 2, (2, 6))])
def test_bank_adapter_delta_matches_reference(rank, l_groups, g, n_bank, lead):
    rng = np.random.default_rng(rank * 100 + n_bank)
    x = rng.standard_normal(lead + (l_groups * g,)).astype(np.float32)
    a = rng.standard_normal((n_bank, l_groups, rank)).astype(np.float32)
    b = rng.standard_normal((n_bank, rank, 24)).astype(np.float32)
    a[0] = b[0] = 0.0
    ids = (np.arange(lead[0]) * 2 % n_bank).astype(np.int32)
    assert 0 in ids
    ref = np.asarray(rq.bank_adapter_delta(jnp.asarray(x), jnp.asarray(a),
                                           jnp.asarray(b), jnp.asarray(ids),
                                           0.7, g))
    got = tq.bank_adapter_delta(_t(x), _t(a), _t(b), _t(ids), 0.7, g).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    assert not got[ids == 0].any()  # the null adapter adds exactly 0


@pytest.mark.parametrize("m", (1, 4, 8))
@pytest.mark.parametrize("bits", BITS)
def test_slot_matvec_plain_matches_pallas_and_reference_dispatch(bits, m):
    c = _bank_case(bits * 10 + m, bits, m)
    _, bn, bk = rops.heuristic_blocks(m, 128, 64, bits, c.g, 4)
    args = (jnp.asarray(c.x), c.rqt.qweight, c.rqt.scale, c.rqt.zero,
            jnp.asarray(c.a), jnp.asarray(c.b))
    pallas = np.asarray(qalora_slot_matvec_pallas(
        *args, jnp.asarray(c.ids), s=1.3, bits=bits, group_size=c.g,
        block_n=bn, block_k=bk, interpret=True))
    disp = np.asarray(rops.qalora_slot_matmul(
        jnp.asarray(c.x), c.rqt, jnp.asarray(c.a), jnp.asarray(c.b),
        jnp.asarray(c.ids), s=1.3, interpret=True))
    got = qalora_slot_matvec_plain(
        _t(c.x), c.tqt.qweight, c.tqt.scale, c.tqt.zero, _t(c.a), _t(c.b),
        _t(c.ids), s=1.3, bits=bits, group_size=c.g).numpy()
    via_ops = tops.qalora_slot_matmul(_t(c.x), c.tqt, _t(c.a), _t(c.b),
                                      _t(c.ids), s=1.3).numpy()
    for ref in (pallas, disp):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(via_ops, got)


@pytest.mark.parametrize("m", (16, 40))
def test_slot_matmul_large_m_matches_reference_fallback(m):
    """M > 8: the tiled base product plus the plain bank delta, against the
    reference's qmatmul plus ``bank_adapter_delta``; leading dims kept."""
    c = _bank_case(m, 4, m)
    x3 = c.x.reshape(2, m // 2, -1)
    ids3 = np.repeat(c.ids[:2, None], m // 2, axis=1)
    ref = np.asarray(rops.qalora_slot_matmul(
        jnp.asarray(x3), c.rqt, jnp.asarray(c.a), jnp.asarray(c.b),
        jnp.asarray(ids3), s=0.9, interpret=True))
    got = tops.qalora_slot_matmul(_t(x3), c.tqt, _t(c.a), _t(c.b), _t(ids3),
                                  s=0.9).numpy()
    assert got.shape == ref.shape == (2, m // 2, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="shape"):
        tops.qalora_slot_matmul(_t(x3), c.tqt, _t(c.a), _t(c.b),
                                _t(c.ids[:2]), s=0.9)


@pytest.mark.parametrize("m", (4, 16))
def test_null_rows_equal_the_base_product_exactly(m):
    c = _bank_case(7, 4, m)
    ids = c.ids.copy()
    ids[::2] = 0
    y = tops.qalora_slot_matmul(_t(c.x), c.tqt, _t(c.a), _t(c.b), _t(ids),
                                s=2.0).numpy()
    base = tops.qmatmul(_t(c.x), c.tqt).numpy()
    np.testing.assert_array_equal(y[ids == 0], base[ids == 0])
    assert not np.array_equal(y[ids != 0], base[ids != 0])
    if m <= 8:
        direct = qmatvec_plain(_t(c.x), c.tqt.qweight, c.tqt.scale,
                               c.tqt.zero, bits=4, group_size=c.g).numpy()
        np.testing.assert_array_equal(y[ids == 0], direct[ids == 0])


def test_slot_wrapper_on_cpu_takes_plain_version_uncounted():
    c = _bank_case(3, 4, 4)
    tkernels.reset_launches()
    qalora_slot_matvec_cuda(_t(c.x), c.tqt.qweight, c.tqt.scale, c.tqt.zero,
                            _t(c.a), _t(c.b), _t(c.ids), s=1.0, bits=4,
                            group_size=c.g)
    assert tkernels.launches()["qalora_slot_matvec"] == 0
    assert "qalora_slot_matvec" in tkernels.KERNELS


# ---------------------------------------------------------------------------
# scheduler and traces
# ---------------------------------------------------------------------------


def _fake_burst(tok, remaining, eos, k, step):
    """The engine's burst semantics in numpy, with made-up argmax tokens."""
    emitted = []
    for j in range(k):
        active = remaining > 0
        nxt = np.where(active, (np.arange(len(tok)) * 7 + (step + j) * 13)
                       % 40 + 4, tok).astype(np.int32)
        emitted.append(np.where(active, nxt, -1))
        stop = active & ((remaining <= 1) | (nxt == eos))
        remaining = np.where(stop, 0, np.where(active, remaining - 1, 0))
        tok = nxt
    return np.stack(emitted), tok, remaining.astype(np.int32)


def _drive(mod, trace, n_slots, max_len, chunk, burst):
    """Serve a trace through one package's Scheduler with made-up tokens;
    returns the log of every plan, commit and burst, and the outputs."""
    sch = mod.Scheduler(n_slots, max_len, chunk)
    for r in trace:
        sch.submit(mod.Request(prompt=r.prompt.copy(),
                               max_new_tokens=r.max_new_tokens,
                               eos_id=r.eos_id, rid=r.rid,
                               adapter_id=r.adapter_id))
    log, step = [], 0
    while sch.has_work:
        log.append(("admit", sch.admit(), sch.slot_adapter_ids().tolist(),
                    sorted(sch.live_adapter_ids()), sch.queue_depth))
        if sch.all_decoding:
            tok, rem, eos = sch.burst_state()
            k_min = int(rem[rem > 0].min())
            k = min(burst, 1 << (k_min.bit_length() - 1))
            emitted, tok_d, rem_d = _fake_burst(tok, rem, eos, k, step)
            done = sch.commit_burst(emitted, tok_d, rem_d)
            log.append(("burst", tok.tolist(), rem.tolist(), eos.tolist(),
                        emitted.tolist(), done))
            step += k
        else:
            tokens, n_new = sch.plan()
            nxt = ((tokens.sum(1) + step) % 40 + 4).astype(np.int32)
            log.append(("plan", tokens.tolist(), n_new.tolist(),
                        sch.commit(nxt)))
            step += 1
    return log, sch.outputs


@pytest.mark.parametrize("n,slots,chunk,burst,eos,seed", [
    (7, 3, 4, 4, None, 5), (9, 2, 3, 8, 17, 1), (12, 4, 8, 2, 9, 7)])
def test_scheduler_plans_and_commits_match_reference(n, slots, chunk, burst,
                                                     eos, seed):
    kw = dict(seed=seed, prompt_lens=(3, 5, 8), gen_lens=(2, 4, 12),
              eos_id=eos, adapter_ids=(1, 2, None))
    r_log, r_out = _drive(rserving, rserving.make_trace(n, 64, **kw),
                          slots, 24, chunk, burst)
    t_log, t_out = _drive(serving, serving.make_trace(n, 64, **kw),
                          slots, 24, chunk, burst)
    assert t_log == r_log
    assert t_out == r_out and len(t_out) == n


def test_trace_helpers_match_reference():
    kw = dict(seed=3, prompt_lens=(2, 6), gen_lens=(5,), eos_id=2,
              adapter_ids=(0, 3), shared_prefix=4)
    for r, t in zip(rserving.make_trace(5, 100, **kw),
                    serving.make_trace(5, 100, **kw)):
        np.testing.assert_array_equal(t.prompt, r.prompt)
        assert (t.max_new_tokens, t.eos_id, t.rid, t.adapter_id) == \
            (r.max_new_tokens, r.eos_id, r.rid, r.adapter_id)
    np.testing.assert_array_equal(serving.poisson_arrivals(6, 2.0, seed=4),
                                  rserving.poisson_arrivals(6, 2.0, seed=4))
    np.testing.assert_array_equal(
        serving.bursty_arrivals(7, 3.0, burst=3, seed=4),
        rserving.bursty_arrivals(7, 3.0, burst=3, seed=4))
    now, slept = [0.0], []

    def sleep(d):
        slept.append(d)
        now[0] += d
    reqs = serving.make_trace(3, 50)
    out = serving.replay(lambda r: r.rid, reqs, [0.5, 0.5, 2.0], speed=2.0,
                         clock=lambda: now[0], sleep=sleep)
    assert out == [0, 1, 2] and slept == [0.25, 0.75]
    groups = serving.static_schedule(reqs, 2)
    assert [([r.rid for r in g], n) for g, n in groups] == [([0, 1], 4),
                                                          ([2], 12)]
    with pytest.raises(ValueError, match="vocab"):
        serving.make_trace(2, 4)


def test_scheduler_refuses_parts_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serving.Scheduler(2, 16, 4, page_table=object())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serving.Scheduler(2, 16, 4, headroom=2)
    sch = serving.Scheduler(1, 8, 4)
    with pytest.raises(ValueError, match="cache positions"):
        sch.submit(serving.Request(prompt=np.ones(5, np.int32),
                                   max_new_tokens=4))


def test_scheduler_cancellation_matches_reference():
    """Queued removal and slot eviction (cancellation) record no output and
    leave the same state in both packages."""
    seen = []
    for mod in (rserving, serving):
        sch = mod.Scheduler(2, 24, 4)
        for r in mod.make_trace(4, 64, seed=2, adapter_ids=(1, 2)):
            sch.submit(r)
        sch.admit()
        evicted = sch.evict_slot(1)
        seen.append((sch.remove_queued(3), sch.remove_queued(9),
                     evicted.req.rid, sch.evict_slot(1), sch.queue_depth,
                     sch.n_active, sorted(sch.live_adapter_ids()),
                     sch.slot_adapter_ids().tolist(), sch.outputs))
    assert seen[1] == seen[0] == (True, False, 1, None, 1, 1, [1], [1, 0],
                                  {})


def test_host_modules_import_neither_torch_nor_jax():
    for name in ("scheduler.py", "trace.py"):
        tree = ast.parse((SRC / "serving" / name).read_text())
        roots = {a.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names}
        roots |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert not roots & {"torch", "jax", "repro"}, (name, roots)


# ---------------------------------------------------------------------------
# AdapterStore and the served slice
# ---------------------------------------------------------------------------


def _noisy(raw, mag, seed):
    """A tenant: the reference tree with seeded numpy noise on every
    adapter leaf (the same tree goes to both packages)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + mag * rng.standard_normal(x.shape).astype(
            x.dtype) if any(getattr(k, "key", None) == "ad" for k in path)
        else x, raw)


TENANTS = (("alpha", 0.02, 1), ("beta", 0.03, 2))


@pytest.fixture(scope="module", params=("gemma3-1b", "llama7b-proxy"))
def served(request):
    arch = request.param
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm, tlm = RLM(rcfg), TLM(tcfg)
    raw = rlm.init(jax.random.PRNGKey(0))
    trees = {name: _noisy(raw, mag, seed) for name, mag, seed in TENANTS}

    def port(tree):
        return bridge.load_numpy_tree(numpy_tree(tree), tcfg, "cpu")
    rstore = rserving.AdapterStore(raw, capacity=3)
    tstore = serving.AdapterStore(port(raw), capacity=3)
    for name, _, _ in TENANTS:
        rstore.register(name, trees[name])
        tstore.register(name, port(trees[name]))
    return SimpleNamespace(arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=tlm,
                           raw=raw, trees=trees, port=port, rstore=rstore,
                           tstore=tstore, prefill=jax.jit(rlm.prefill))


def _ref_generate(p, tree, prompt, gen_len, max_len):
    """The reference's no-mesh static path for one request."""
    toks = jnp.asarray(prompt[None])
    logits, pre = p.prefill(tree, {"tokens": toks})
    cache = p.rlm.merge_prefill_cache(
        pre, p.rlm.init_cache(1, max_len, dtype=jnp.float32))
    out, _ = p.rlm.generate(tree, cache, logits, gen_len)
    return [int(t) for t in np.asarray(out)[0]]


def test_store_merged_zeros_match_reference(served):
    for name in (None, "alpha", "beta"):
        rm, tm = served.rstore.merged(name), served.tstore.merged(name)
        for layer in range(served.tcfg.n_layers):
            for a, b in (("attn", "wq"), ("attn", "wo"), ("mlp", "down")):
                ref = RS.quantized_base(rm["blocks"][a][b])
                got = TS.quantized_base(tm.blocks[layer][a][b])
                np.testing.assert_array_equal(
                    got.qweight.numpy(), np.asarray(ref.qweight)[layer])
                np.testing.assert_allclose(got.zero.numpy(),
                                           np.asarray(ref.zero)[layer],
                                           rtol=1e-6, atol=1e-7)
    assert served.tstore.resolve("beta") == served.rstore.resolve("beta")


def test_store_lifecycle_matches_reference(served):
    """register / resolve / LRU eviction under the live guard / explicit
    eviction zeroing its row / re-register in place, step for step with
    the reference store."""
    stores = {"jax": rserving.AdapterStore(served.raw, capacity=2),
              "torch": serving.AdapterStore(served.port(served.raw),
                                            capacity=2)}
    gamma = _noisy(served.raw, 0.05, 3)
    trees = {"jax": dict(served.trees, gamma=gamma),
             "torch": {k: served.port(v)
                       for k, v in dict(served.trees, gamma=gamma).items()}}
    seen = {}
    for kind, st in stores.items():
        ids = [st.register("alpha", trees[kind]["alpha"]),
               st.register("beta", trees[kind]["beta"])]
        st.set_live([ids[0], ids[1]])
        with pytest.raises(RuntimeError, match="live"):
            st.register("gamma", trees[kind]["gamma"])
        with pytest.raises(RuntimeError, match="live"):
            st.evict("alpha")
        st.set_live([ids[1]])          # alpha drained: the LRU victim
        ids.append(st.register("gamma", trees[kind]["gamma"]))
        with pytest.raises(ValueError, match="unknown adapter"):
            st.resolve("alpha")
        st.set_live([])
        version = st.version
        ids.append(st.register("beta", trees[kind]["alpha"]))  # in place
        assert st.version == version + 1
        st.evict("gamma")
        with pytest.raises(KeyError):
            st.evict("gamma")
        seen[kind] = (ids, st.names, st.n_adapters)
    assert seen["torch"] == seen["jax"]
    ids = seen["torch"][0]
    assert ids[2] == ids[0] and ids[3] == ids[1]

    st = stores["torch"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, served.tcfg.d_model)).astype(np.float32))
    # the evicted row is zeroed: its stale id serves the bare base
    lp = st.with_slot_ids([ids[2], 0]).blocks[0]["attn"]["wq"]
    base_lp = st.base.blocks[0]["attn"]["wq"]
    assert lp.scheme == "qalora_slot"
    np.testing.assert_array_equal(TS.linear_apply(lp, x).numpy(),
                                  TS.linear_apply(base_lp, x).numpy())
    # beta's row now holds alpha's adapter
    alpha_m = stores["jax"].merged("beta")["blocks"]["attn"]["wq"]
    np.testing.assert_allclose(
        TS.quantized_base(st.merged("beta").blocks[0]["attn"]["wq"])
        .zero.numpy(), np.asarray(RS.quantized_base(alpha_m).zero)[0],
        rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="slot adapter ids"):
        st.with_slot_ids([0, 3])


def test_slot_scheme_rows_match_merged_linears(served):
    """A qalora_slot linear applies each row's own tenant: row b equals the
    tenant's merged linear on that row, within f32 summation order."""
    st = served.tstore
    ids = [st.resolve("beta"), 0, st.resolve("alpha")]
    lp = st.with_slot_ids(ids).blocks[1]["mlp"]["down"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, served.tcfg.d_ff)).astype(np.float32))
    y = TS.linear_apply(lp, x)
    for row, name in enumerate(("beta", None, "alpha")):
        ref = TS.linear_apply(st.merged(name).blocks[1]["mlp"]["down"],
                              x[row])
        np.testing.assert_allclose(y[row].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())
    assert TS.quantized_base(lp) is TS.quantized_base(
        st.base.blocks[1]["mlp"]["down"])
    scheme = TS.get_scheme("qalora_slot")
    with pytest.raises(NotImplementedError):
        scheme.init(None, 8, 8, lp.policy, "cpu")
    with pytest.raises(NotImplementedError):
        TS.merge_linear(lp)


def _mixed_trace(cfg, mod):
    """Seven mixed requests over three slots (slots evict and refill) plus
    one prompt served once by each tenant."""
    trace = mod.make_trace(7, cfg.vocab, seed=5, prompt_lens=(3, 5, 4),
                           gen_lens=(6, 4, 5))
    whos = ["alpha", "beta", None, "alpha", "beta", "alpha", None]
    trace += [dataclasses.replace(trace[1], rid=7, max_new_tokens=6),
              dataclasses.replace(trace[1], rid=8, max_new_tokens=6)]
    return trace, whos + ["alpha", "beta"]


def test_engine_streams_match_reference_engine_and_merged(served):
    """The slice: the port's ContinuousEngine over its AdapterStore gives
    token for token the reference ContinuousEngine's streams, and each
    request's stream served alone on its tenant's merged tree (reference,
    no mesh, and the port's static path)."""
    max_len = 24
    out = {}
    for kind, mod, lm, store in (
            ("jax", rserving, served.rlm, served.rstore),
            ("torch", serving, served.tlm, served.tstore)):
        trace, whos = _mixed_trace(served.rcfg, mod)
        eng = mod.ContinuousEngine(lm, store.base, n_slots=3,
                                   max_len=max_len, prefill_chunk=4,
                                   decode_burst=4, adapters=store)
        for r, who in zip(trace, whos):
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid,
                       adapter_id=who)
        out[kind] = eng.run()
        if kind == "torch":
            stats = eng.stats
    assert out["torch"] == out["jax"]
    assert sorted(out["torch"]) == list(range(9))
    for r, who in zip(trace, whos):
        ref = _ref_generate(served, served.rstore.merged(who), r.prompt,
                            r.max_new_tokens, max_len)
        port, _ = tserve.generate(served.tlm, served.tstore.merged(who),
                                  r.prompt[None], r.max_new_tokens, max_len,
                                  device="cpu")
        assert out["torch"][r.rid] == ref == port[0].tolist(), (r.rid, who)
    assert out["torch"][7] != out["torch"][8], \
        "alpha and beta gave the same stream for one prompt"
    assert stats.ragged_dispatches >= 3 and stats.tokens_out == sum(
        r.max_new_tokens for r in trace)
    assert 0 < stats.occupancy <= 1


def test_engine_rebinds_after_store_changes(served):
    """Register past capacity (evicting a drained tenant) between runs: the
    store's version makes the engine rebuild its tree, the new tenant
    serves its merged reference, and the evicted name is refused."""
    st = serving.AdapterStore(served.port(served.raw), capacity=2)
    st.register("alpha", served.port(served.trees["alpha"]))
    st.register("beta", served.port(served.trees["beta"]))
    trace = serving.make_trace(2, served.tcfg.vocab, seed=11,
                               prompt_lens=(4,), gen_lens=(5,))
    eng = serving.ContinuousEngine(served.tlm, st.base, n_slots=2,
                                   max_len=16, prefill_chunk=4,
                                   decode_burst=4, adapters=st)
    eng.submit(trace[0].prompt, 5, rid=0, adapter_id="alpha")
    assert eng.run()[0] == tserve.generate(
        served.tlm, st.merged("alpha"), trace[0].prompt[None], 5, 16,
        device="cpu")[0][0].tolist()
    st.touch(st.resolve("beta"))                 # alpha becomes the LRU
    assert st.register("gamma", served.port(_noisy(served.raw, 0.05, 3))) \
        == 1
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(trace[1].prompt, 5, adapter_id="alpha")
    eng.submit(trace[1].prompt, 5, rid=1, adapter_id="gamma")
    assert eng.run()[1] == tserve.generate(
        served.tlm, st.merged("gamma"), trace[1].prompt[None], 5, 16,
        device="cpu")[0][0].tolist()


def test_poisoned_engine_raises_before_commit(served):
    eng = serving.ContinuousEngine(served.tlm, served.tstore.base, n_slots=2,
                                   max_len=16, prefill_chunk=4,
                                   adapters=served.tstore)
    eng.submit(np.arange(4, 10, dtype=np.int32), 4, adapter_id="beta")
    eng.step_once()
    eng.step_once()                      # prompt done, first token emitted
    emitted = list(eng.sched.slots[0].emitted)
    eng.poison_cache()
    with pytest.raises(serving.EngineCorrupted):
        eng.step_once()
    assert eng.sched.slots[0].emitted == emitted
    eng.reset()
    assert not eng.sched.has_work


def test_engine_refuses_modes_not_ported(served):
    base = served.tstore.base
    for kw in ({"page_size": 4}, {"speculate": 2}, {"drafter": "*=intq8"},
               {"max_src": 8}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            serving.ContinuousEngine(served.tlm, base, n_slots=2, max_len=8,
                                     **kw)
    eng = serving.ContinuousEngine(served.tlm, base, n_slots=2, max_len=8)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        eng.submit([5, 6], 2, src=np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="no AdapterStore"):
        eng.submit([5, 6], 2, adapter_id="alpha")


@pytest.mark.parametrize("argv", (
    ["--arch", "gemma3-1b", "--requests", "5", "--slots", "2",
     "--prompt-len", "6", "--prefill-chunk", "4",
     "--adapters", "alice=demo:1,bob=demo:2"],
    ["--arch", "llama7b-proxy", "--requests", "3", "--prompt-len", "5"],
))
def test_serve_cli_continuous_cpu(argv):
    tkernels.reset_launches()
    out = tserve.main(argv + ["--engine", "continuous", "--gen-len", "4",
                              "--decode-burst", "4", "--device", "cpu",
                              "--reduced", "--verify"])
    n = int(argv[argv.index("--requests") + 1])
    assert out["tokens"].shape == (n, 4) and out["tokens_out"] == n * 4
    assert set(out["launches_engine"].values()) == {0}
    checks = out.get("tenant_check") or {"base": out["merge_check"]}
    for check in checks.values():
        for r in check.values():
            assert r["rel"] <= out["merge_bound_rel"]
    if "--adapters" in argv:
        assert out["tenants"] == ["alice", "bob"] and out["bank_bytes"] > 0
        first = {name: tuple(c["prefill"]["argmax"])
                 for name, c in checks.items()}
        assert first["alice"] != first["bob"]
        cross = out["tenant_cross_check"]
        assert all(checks[t][ph]["rel"] < cross[t][ph]["rel"]
                   for t in cross for ph in cross[t])
        # one tree with mixed ids: each row against its own tenant
        mixed = out["mixed_check"]
        assert mixed["tenants"] == ["alice", "bob", "<null>", "alice", "bob"]
        for ph in ("prefill", "decode"):
            assert all(o <= out["merge_bound_rel"] and o < f for o, f in
                       zip(mixed[ph]["rel"], mixed[ph]["next_rel"]))


def test_serve_cli_adapters_need_the_continuous_engine(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu", "--adapters",
                     "a=demo:1"])
    assert "--engine continuous" in capsys.readouterr().err
