"""Parity of the port's recurrent families, mamba_hybrid (zamba2-7b: groups
of Mamba2 layers, each followed by the one shared attention block, then a
tail) and rwkv (rwkv6-7b), with the JAX package, on the CPU at
``reduced()`` sizes in f32, with no mesh.

The reference tree from ``LM.init`` (adapters nudged by +0.01, as its
serve CLI nudges them) goes to the port through numpy and
``repro_torch.bridge``.  Prefill logits and caches within 1e-5 of
``jax.jit(lm.prefill)``; static greedy tokens identical to the
reference's ``merge_prefill_cache`` + ``generate``; the continuous engine
(contiguous, and paged for zamba2) and ``ServingFrontend`` through a
crash and a NaN against the reference's, stream for stream; rwkv's tenants
against the reference's AdapterStore engine; the slot state's layout, its
reset and clear (STATE zeroed, CACHE kept) and the refusals (speculation,
and paging rwkv, with the reference's reasons); the loss and every
adapter's gradient within 1e-5 of ``jax.value_and_grad``, with and without
remat; one train CLI step against ``make_train_fn``; the bridge's round
trip; the serve CLI.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro import runtime as rruntime  # noqa: E402
from repro import serving as rserving  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.data import make_stream as ref_stream  # noqa: E402
from repro.launch.steps import make_train_fn as ref_train_fn  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import merge_params, split_params  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, runtime, serving  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.models.slot_state import SlotState  # noqa: E402
from _torch_parity import bump, numpy_tree, ref_adapters  # noqa: E402
from test_torch_train import _close  # noqa: E402

ARCHS = ("zamba2-7b", "rwkv6-7b")
TOL = 1e-5
PROMPT = 32  # two chunks of the reduced ssm_chunk 16
GEN_LEN = 5
ENGINE = dict(n_slots=2, max_len=24, prefill_chunk=4, decode_burst=2)
# prompt lengths, new tokens: more requests than slots, refills, ragged
TRACE = dict(n_requests=5, seed=3, prompt_lens=(3, 5, 9), gen_lens=(4, 6, 3))


def _pair(arch):
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm = RLM(rcfg)
    params = bump(jax.jit(rlm.init)(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    tree = numpy_tree(params)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg),
        params=params, merged=merged, tree=tree,
        tparams=bridge.load_numpy_tree(tree, tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        prompts=np.random.default_rng(0).integers(
            4, rcfg.vocab, size=(2, PROMPT)).astype(np.int32))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def rwkv():
    return _pair("rwkv6-7b")


def _rel(got, want, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{where}: {err:.3e} of max|ref| > {TOL}"


def _flat(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], keys + (k,))
    else:
        yield "/".join(keys), tree


def test_step_linears_count_the_shared_block_per_application():
    """zamba2-7b cut to 15 layers is 2 groups of 5 Mamba2 layers (2
    linears each) and the shared block (7) applied twice, then a tail of
    3; rwkv6-7b has 8 linears a layer; the reduced models' trees hold
    those linears (the shared block's once)."""
    z = TLM(TC.get("zamba2-7b").scaled(n_layers=15))
    assert [z.layer_linears(i) for i in range(15)] == \
        [2] * 5 + [7] + [2] * 5 + [7] + [2] * 3
    assert z.step_linears() == 13 * 2 + 2 * 7
    assert TLM(TC.get("rwkv6-7b")).step_linears() == 32 * 8
    for arch, held in (("zamba2-7b", 3 * 2 + 7), ("rwkv6-7b", 2 * 8)):
        lm = TLM(TC.reduced(arch))
        params = lm.init(torch.Generator().manual_seed(0), "cpu")
        quantized = [m for m in params.modules()
                     if TS.is_linear(m) and m.scheme != "fp"]
        assert len(quantized) == held, arch


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_matches_reference(pair, which):
    """Last-token prefill logits within 1e-5 of ``jax.jit(lm.prefill)``
    over two chunks, every cache leaf (the recurrent states, zamba2's
    shared-block K/V) likewise, and the length."""
    rp, tp = ((pair.params, pair.tparams) if which == "adapter"
              else (pair.merged, pair.tmerged))
    r_logits, r_cache = jax.jit(pair.rlm.prefill)(
        rp, {"tokens": jnp.asarray(pair.prompts)})
    t_logits, t_cache = pair.tlm.prefill(
        tp, {"tokens": torch.from_numpy(pair.prompts)})
    _rel(t_logits.numpy(), r_logits, "logits")
    got, want = dict(_flat(t_cache["layers"])), dict(_flat(r_cache["layers"]))
    assert set(got) == set(want)
    for k in want:
        _rel(got[k].numpy(), want[k], k)
    np.testing.assert_array_equal(t_cache["len"].numpy(), r_cache["len"])


def test_greedy_tokens_identical_to_reference_generate(pair):
    """The static path (prefill, merge into the decode cache, greedy
    decode) gives the reference's ``merge_prefill_cache`` + ``generate``
    tokens, on the adapter tree and the merged one."""
    max_len = PROMPT + GEN_LEN
    for rp, tp in ((pair.params, pair.tparams), (pair.merged, pair.tmerged)):
        logits, pre = jax.jit(pair.rlm.prefill)(
            rp, {"tokens": jnp.asarray(pair.prompts)})
        cache = pair.rlm.merge_prefill_cache(
            pre, pair.rlm.init_cache(2, max_len, dtype=jnp.float32))
        want, _ = pair.rlm.generate(rp, cache, logits, GEN_LEN)
        got, _ = tserve.generate(pair.tlm, tp, pair.prompts, GEN_LEN,
                                 max_len, device="cpu")
        np.testing.assert_array_equal(got, np.asarray(want))


def _serve(mod, lm, tree, trace, **kw):
    eng = mod.ContinuousEngine(lm, tree, **{**ENGINE, **kw})
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng.run()


def test_engine_streams_match_reference(pair):
    """A trace with refills through the port's continuous engine equals
    the reference ``ContinuousEngine``'s streams; zamba2 also paged (its
    shared block's K/V in pages of 4), against the reference's paged
    engine and the port's contiguous one."""
    trace = serving.make_trace(**TRACE, vocab=pair.rcfg.vocab)
    want = _serve(rserving, pair.rlm, pair.merged, trace)
    got = _serve(serving, pair.tlm, pair.tmerged, trace)
    assert got == want and len(got) == TRACE["n_requests"]
    if pair.arch == "zamba2-7b":
        paged = _serve(serving, pair.tlm, pair.tmerged, trace, page_size=4)
        assert paged == _serve(rserving, pair.rlm, pair.merged, trace,
                               page_size=4) == got


def test_slot_state_layout_reset_and_clear(pair):
    """The layout is the reference's (shapes and dtypes, contiguous and,
    for zamba2, paged, with a bf16 cache dtype: the STATE leaves keep
    theirs); ``supports_rollback()`` is False in both packages; ``reset``
    zeroes a refilled slot's STATE leaves and length and keeps its CACHE
    rows and the other slot's everything; ``clear`` zeroes all."""
    pagings = ((0, 0), (4, 9)) if pair.arch == "zamba2-7b" else ((0, 0),)
    for ps, n_pages in pagings:
        r = pair.rlm.slot_state(ps, n_pages).init(2, 16, dtype=jnp.bfloat16)
        t = SlotState(pair.tcfg, ps, n_pages).init(
            2, 16, dtype=torch.bfloat16, device="cpu")
        rl, tl = dict(_flat(r)), dict(_flat(t))
        assert set(rl) == set(tl)
        for k in rl:
            assert tuple(tl[k].shape) == rl[k].shape, k
            assert str(tl[k].dtype).split(".")[-1] == str(rl[k].dtype), k
    assert not pair.rlm.slot_state().supports_rollback()
    assert not SlotState(pair.tcfg).supports_rollback()
    ss = SlotState(pair.tcfg)
    cache = ss.init(2, 16, dtype=torch.float32, device="cpu")
    for t in (*_flat_tensors(cache["layers"]), cache["len"]):
        t.copy_(torch.randn(t.shape).to(t.dtype) + 1 if t.is_floating_point()
                else torch.full(t.shape, 7, dtype=t.dtype))
    before = {k: v.clone() for k, v in _flat(cache)}
    states = {id(t) for t in ss.state_leaves(cache)}
    assert states
    ss.reset(cache, torch.tensor([True, False]))
    for k, v in _flat(cache):
        old = before[k]
        ax = 0 if k == "len" else (2 if "/groups/" in k else 1)
        slot0 = v.select(ax, 0)
        np.testing.assert_array_equal(v.select(ax, 1).numpy(),
                                      old.select(ax, 1).numpy())
        if k == "len" or id(v) in states:
            assert not slot0.any(), k
        else:
            np.testing.assert_array_equal(slot0.numpy(),
                                          old.select(ax, 0).numpy())
    ss.clear(cache)
    assert not any(v.any() for _, v in _flat(cache))


def _flat_tensors(layers):
    return [t for _, t in _flat(layers)]


def test_refusals_with_the_references_reasons(pair):
    """Speculation is refused over both families (their state cannot be
    rolled back) and paging over rwkv (no CACHE leaf), each with the
    reference's words, in both packages."""
    for mod, lm, tree in ((rserving, pair.rlm, pair.merged),
                          (serving, pair.tlm, pair.tmerged)):
        with pytest.raises(NotImplementedError,
                           match="mutates per-slot recurrent STATE"):
            mod.ContinuousEngine(lm, tree, **{**ENGINE, "decode_burst": 1},
                                 speculate=2, drafter="*=intq8")
        if pair.arch == "rwkv6-7b":
            with pytest.raises(ValueError, match="nothing to page"):
                mod.ContinuousEngine(lm, tree, **ENGINE, page_size=4)


def test_tenants_match_the_references_store_engine(rwkv):
    """rwkv6-7b serves tenants, as the reference does: two tenants (the
    reference tree with seeded noise on its adapters) and the null adapter
    through each package's AdapterStore engine, streams equal."""
    rng = np.random.default_rng(1)

    def noisy(mag):
        return jax.tree_util.tree_map_with_path(
            lambda path, x: x + mag * rng.standard_normal(x.shape).astype(
                x.dtype) if any(getattr(k, "key", None) == "ad"
                                for k in path) else x, rwkv.params)
    tenants = {"alpha": noisy(0.02), "beta": noisy(0.03)}
    trace = serving.make_trace(**TRACE, vocab=rwkv.rcfg.vocab)
    whos = ["alpha", "beta", None, "beta", "alpha"]
    out = {}
    for mod, lm, port in ((rserving, rwkv.rlm, False),
                          (serving, rwkv.tlm, True)):
        def tree(p):
            return bridge.load_numpy_tree(numpy_tree(p), rwkv.tcfg,
                                          "cpu") if port else p
        store = mod.AdapterStore(tree(rwkv.params), capacity=2)
        for name, p in tenants.items():
            store.register(name, tree(p))
        eng = mod.ContinuousEngine(lm, store.base, adapters=store, **ENGINE)
        for r, who in zip(trace, whos):
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid,
                       adapter_id=who)
        out[port] = eng.run()
    assert out[True] == out[False]
    assert len({tuple(v) for v in out[True].values()}) > 1


def test_frontend_recovers_as_the_reference(pair):
    """``ServingFrontend`` over each family's engine through a crash and a
    NaN: tickets (status, tokens, recoveries), the injector's log and the
    engines' counters equal the reference's, and every recovered stream is
    the clean run's (a refilled slot starts from zeroed state)."""
    trace = serving.make_trace(**TRACE, vocab=pair.rcfg.vocab)
    got = {}
    for side, mod, rt, lm, tree in (
            ("ref", rserving, rruntime, pair.rlm, pair.merged),
            ("port", serving, runtime, pair.tlm, pair.tmerged)):
        inj = rt.FaultInjector(seed=0, crash_steps=(3,), nan_steps=(6,))
        fe = mod.ServingFrontend(lm, tree, **ENGINE, queue_cap=len(trace),
                                 injector=inj)
        for r in trace:
            fe.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id, rid=r.rid)
        fe.run_until_drained()
        got[side] = (fe, inj)
    (fe, inj), (rfe, rinj) = got["port"], got["ref"]

    def tickets(f):
        return {t.rid: (t.status.name, list(t.tokens), t.n_recoveries)
                for t in f.tickets.values()}
    assert tickets(fe) == tickets(rfe)
    assert inj.log == rinj.log and fe.n_recoveries == rfe.n_recoveries == 2
    assert {k: getattr(fe.engine_stats, k) for k in (
        "model_steps", "dispatches", "tokens_out")} == \
        {k: getattr(rfe.engine_stats, k) for k in (
            "model_steps", "dispatches", "tokens_out")}
    clean = _serve(serving, pair.tlm, pair.tmerged, trace)
    assert {t.rid: list(t.tokens) for t in fe.tickets.values()} == clean


def _batch(seed=1, b=3, s=PROMPT):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 256, size=(b, s)).astype(np.int32)
    labs = rng.integers(-1, 256, size=(b, s)).astype(np.int32)
    labs[1] = -1
    return toks, labs


@pytest.fixture(scope="module")
def ref_grads(pair):
    toks, labs = _batch()
    trainable, frozen = split_params(pair.params)

    def loss_fn(tr):
        return pair.rlm.loss(merge_params(tr, frozen),
                             {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labs)})
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable)
    return r_loss, r_m, ref_adapters(r_grads)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_and_grads_match_reference(pair, ref_grads, remat):
    """The loss and xent within 1e-5 of ``jax.value_and_grad`` of the
    reference's ``LM.loss`` over two chunks, and every adapter's gradient
    (each Mamba2 layer's, the shared block's summed over its
    applications, each RWKV6 linear's) finite and within 1e-5 of its
    tensor's largest, with and without remat."""
    r_loss, r_m, want = ref_grads
    tcfg = TC.reduced(pair.arch, remat=remat)
    tlm, tparams = TLM(tcfg), bridge.load_numpy_tree(pair.tree, tcfg, "cpu")
    toks, labs = _batch()
    tr = TS.trainable_tensors(tparams)
    t_loss, t_m = tlm.loss(tparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labs)})
    grads = torch.autograd.grad(t_loss, list(tr.values()))
    _close(t_loss.detach().numpy(), np.asarray(r_loss), where="loss")
    _close(t_m["xent"].detach().numpy(), np.asarray(r_m["xent"]),
           where="xent")
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _close(bridge.adapters_numpy(tparams, dict(zip(tr, grads))), want)


def test_train_cli_step_matches_make_train_fn(pair):
    """One step of ``train --arch <arch> --reduced --device cpu`` over the
    reference's tree against ``jax.jit(make_train_fn)`` on the reference
    stream's batch: loss, xent and grad_norm within 1e-5, the moments
    within 1e-5 / 2e-5, every adapter within the Adam allowance."""
    from test_torch_train import _adam_allowance
    from repro_torch.optim import AdamWConfig
    argv = ["--arch", pair.arch, "--reduced", "--device", "cpu", "--steps",
            "1", "--seq-len", str(PROMPT), "--global-batch", "2", "--lr",
            "2e-4"]
    args = ttrain.build_parser().parse_args(argv)
    tparams = bridge.load_numpy_tree(pair.tree, pair.tcfg, "cpu")
    res = ttrain.run(ttrain.setup(args, params=tparams), args)
    toks, labs = ref_stream("alpaca", vocab=256, seq_len=PROMPT,
                            global_batch=2).next_batch()
    r_tr, r_fr = split_params(pair.params)
    r_opt = ref_adamw_init(r_tr)
    r_tr, r_opt, r_m = jax.jit(ref_train_fn(pair.rlm, RAdamW(
        lr=2e-4, schedule="constant")))(
        r_tr, r_fr, r_opt, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labs)})
    for k in ("loss", "xent", "grad_norm"):
        _close(np.asarray(res[k][0]), np.asarray(r_m[k]), where=k)
    st = res["state"]
    port = tuple(bridge.adapters_numpy(st.params, st.opt_state[k])
                 for k in ("mu", "nu"))
    want = tuple(ref_adapters(r_opt[k]) for k in ("mu", "nu"))
    _close(port[0], want[0], where="mu")
    _close(port[1], want[1], rel=2e-5, where="nu")
    allow = _adam_allowance([(port, want)],
                            AdamWConfig(lr=2e-4, schedule="constant"))
    _close(bridge.adapters_numpy(st.params), ref_adapters(r_tr), allow=allow)


def test_bridge_roundtrips_the_tree(pair):
    """``numpy_tree`` of the loaded port tree gives the reference's tree
    back (rwkv's blocks with their fp leaves; zamba2's groups stacked [G,
    P], its tail [T] and the shared block with no layer axis), and
    ``load_adapters`` of its adapters is exact."""
    back = bridge.numpy_tree(pair.tparams)

    def same(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), (path, sorted(g), sorted(w))
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=path)
        else:
            assert g == w, path
    same(back, pair.tree)
    tparams = bridge.load_numpy_tree(pair.tree, pair.tcfg, "cpu")
    for t in TS.trainable_tensors(tparams).values():
        torch.nn.init.zeros_(t)
    bridge.load_adapters(tparams, ref_adapters(pair.params))
    _close(bridge.adapters_numpy(tparams), ref_adapters(pair.params), rel=0)


CLI = ["--reduced", "--device", "cpu", "--requests", "2", "--prompt-len",
       "8", "--gen-len", "5"]


def test_serve_cli(pair, monkeypatch, capsys):
    """``serve --arch <arch> --reduced --device cpu --verify`` serves the
    reference's tree with the reference's static tokens and its merge
    within bound; ``--engine continuous`` gives them too; ``--speculate``
    (and, for rwkv, ``--page-size``) is refused with the reference's
    reason."""
    monkeypatch.setattr(tserve, "build_model",
                        lambda cfg, device, seed=0, bump=True:
                        (pair.tlm, pair.tparams, pair.tmerged))
    argv = ["--arch", pair.arch] + CLI
    res = tserve.main(argv + ["--verify"])
    prompts = np.random.default_rng(0).integers(
        4, pair.rcfg.vocab, size=(2, 8)).astype(np.int32)
    logits, pre = jax.jit(pair.rlm.prefill)(pair.merged,
                                            {"tokens": jnp.asarray(prompts)})
    cache = pair.rlm.merge_prefill_cache(
        pre, pair.rlm.init_cache(2, 13, dtype=jnp.float32))
    want, _ = pair.rlm.generate(pair.merged, cache, logits, 5)
    np.testing.assert_array_equal(res["tokens"], np.asarray(want))
    assert all(r["rel"] <= res["merge_bound_rel"]
               for r in res["merge_check"].values())
    cont = tserve.main(argv + ["--engine", "continuous"])
    np.testing.assert_array_equal(cont["tokens"], np.asarray(want))
    refused = [["--speculate", "2"]] + (
        [["--page-size", "4"]] if pair.arch == "rwkv6-7b" else [])
    for extra in refused:
        with pytest.raises(SystemExit):
            tserve.main(argv + ["--engine", "continuous", *extra])
        err = capsys.readouterr().err
        assert "recurrent STATE" in err or "nothing to page" in err


def _cut_and_resumed(arch, tmp_path, extra=()):
    """``train --arch <arch> --reduced --device cpu`` run 4 steps whole,
    and cut at step 2 then resumed from its checkpoint."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--seq-len",
            "32", "--global-batch", "2", "--ckpt-every", "2", *extra]
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    full = ttrain.main(argv + ["--steps", "4", "--ckpt-dir", whole])
    first = ttrain.main(argv + ["--steps", "2", "--ckpt-dir", cut])
    resumed = ttrain.main(argv + ["--steps", "4", "--ckpt-dir", cut])
    return full, first, resumed


def assert_resumed_bit_for_bit(full, first, resumed):
    assert resumed["start"] == 2 and resumed["steps"] == [2, 3]
    assert first["loss"] + resumed["loss"] == full["loss"]
    a, b = (r["state"].trainable for r in (full, resumed))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    for key in ("mu", "nu"):
        assert all(torch.equal(full["state"].opt_state[key][k],
                               resumed["state"].opt_state[key][k]) for k in a)
    assert all(np.isfinite(full["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_cut_and_resumed_equals_uninterrupted(arch, tmp_path):
    """The train CLI on each recurrent family, cut at step 2 and resumed
    from its checkpoint: the losses, the adapters and AdamW's moments
    equal the uninterrupted run's bit for bit (the CPU's counterpart of
    chip_smoke's rec_train_resume)."""
    assert_resumed_bit_for_bit(*_cut_and_resumed(arch, tmp_path))
