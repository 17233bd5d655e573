"""Parity of the port's encdec family (seamless-m4t-medium: an encoder
over the audio frontend's frames and a decoder with cross-attention to its
memory) with the JAX package, on the CPU at ``reduced()`` sizes in f32,
with no mesh.

The reference tree from ``LM.init`` (adapters nudged by +0.01, as its
serve CLI nudges them) goes to the port through numpy and
``repro_torch.bridge``.  ``encode_cross``, unbucketed and bucketed, within
1e-5 of ``jax.jit(lm.encode_cross)`` unbucketed; prefill logits and caches
within 1e-5 of ``jax.jit(lm.prefill)``; greedy tokens identical to the
reference's ``merge_prefill_cache`` + ``generate`` (and, without frames,
to its per-token loop); the continuous engine, contiguous and paged,
stream for stream against the reference's ``ContinuousEngine(max_src=...)``
on ``tests/test_serving_encdec.py``'s traces and against each request
served alone statically; the encoder's captures within their budget; the
slot state's layout, reset and clear; the loss and every adapter's
gradient (plain and remat) within 1e-5 of ``jax.value_and_grad``; one
train CLI step against ``make_train_fn`` on the reference's split; the
bridge's round trip; the refusals with the reference's reasons;
``ServingFrontend`` through a crash and a NaN with source frames; the
serve CLI.
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
from repro.launch import serve as rserve  # noqa: E402
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
from repro_torch.runtime import compile_guard as port_guard  # noqa: E402
from repro_torch.serving.engine import src_buckets  # noqa: E402
from _torch_parity import bump, numpy_tree, ref_adapters  # noqa: E402
from test_torch_graphs import stand_in  # noqa: E402
from test_torch_train import _close  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = 1e-5
MAX_SRC = 8
PROMPT, SRC, GEN_LEN = 8, 6, 5
# tests/test_serving_encdec.py's traces: (make_trace arguments, src
# lengths by rid, engine arguments)
TRACES = {
    "mixed_with_src_less_refill": (
        dict(n_requests=5, seed=3, prompt_lens=(3, 6), gen_lens=(2, 7, 4)),
        (4, 7, 0, 5, 4),
        dict(n_slots=2, max_len=16, prefill_chunk=4, decode_burst=4)),
    "two_slots_two_memories": (
        dict(n_requests=2, seed=9, prompt_lens=(4,), gen_lens=(6,)),
        (6, 3),
        dict(n_slots=2, max_len=12, prefill_chunk=4, decode_burst=4)),
    "fast_lane": (
        dict(n_requests=3, seed=2, prompt_lens=(2, 4), gen_lens=(2, 3)),
        (3, 0, 5),
        dict(n_slots=2, max_len=8, prefill_chunk=4, decode_burst=2))}


@pytest.fixture(scope="module")
def pair():
    rcfg, tcfg = RC.reduced(ARCH), TC.reduced(ARCH)
    rlm = RLM(rcfg)
    params = bump(jax.jit(rlm.init)(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    tree = numpy_tree(params)
    rng = np.random.default_rng(0)
    return SimpleNamespace(
        rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg), params=params,
        merged=merged, tree=tree,
        tparams=bridge.load_numpy_tree(tree, tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        prompts=rng.integers(4, rcfg.vocab, size=(2, PROMPT)).astype(
            np.int32),
        src=(rng.normal(size=(2, SRC, rcfg.d_model)) * 0.3).astype(
            np.float32))


def _src(cfg, ss, seed):
    """tests/test_serving_encdec.py's frames: None for a src-less
    request."""
    if ss == 0:
        return None
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ss, cfg.d_model)) * 0.3).astype(np.float32)


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


def test_linear_counts():
    """seamless-m4t-medium: an encoder block has 6 quantized linears, a
    decoder block 10 in a prefill or the loss and 8 in a decode or ragged
    step (the cross wk and wv run once, at admission); the reduced tree
    holds 2 x 6 + 2 x 10 of them."""
    lm = TLM(TC.get(ARCH))
    assert lm.step_linears() == 12 * 8
    assert lm.encode_linears() == 12 * 6 + 12 * 2
    assert lm.pass_linears() == 12 * 6 + 12 * 10
    small = TLM(TC.reduced(ARCH))
    params = small.init(torch.Generator().manual_seed(0), "cpu")
    quantized = [m for m in params.modules()
                 if TS.is_linear(m) and m.scheme != "fp"]
    assert len(quantized) == small.pass_linears() == 2 * 6 + 2 * 10


@pytest.mark.parametrize("ss", (3, 5, 7))
@pytest.mark.parametrize("bucketed", (False, True),
                         ids=("unbucketed", "bucketed"))
def test_encode_cross_matches_reference(pair, ss, bucketed):
    """The port's ``encode_cross`` within 1e-5 of the reference's on the
    unpadded source: unpadded, and zero-padded to the next power of two
    with the true length as its key mask (the engine's buckets; the
    reference's own bucketed encode is not bit-identical to its unpadded
    one, so the port is held to the unpadded)."""
    src = _src(pair.rcfg, ss, 70 + ss)
    rk, rv = jax.jit(pair.rlm.encode_cross)(pair.merged,
                                            jnp.asarray(src)[None])
    if bucketed:
        bs = 1 << (ss - 1).bit_length()
        pad = np.zeros((1, bs, pair.rcfg.d_model), np.float32)
        pad[0, :ss] = src
        tk, tv = pair.tlm.encode_cross(pair.tmerged, torch.from_numpy(pad),
                                       torch.tensor([ss], dtype=torch.int32))
        tk, tv = tk[:, :, :ss], tv[:, :, :ss]
    else:
        tk, tv = pair.tlm.encode_cross(pair.tmerged,
                                       torch.from_numpy(src)[None])
    _rel(tk.numpy(), rk, "k")
    _rel(tv.numpy(), rv, "v")


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_matches_reference(pair, which):
    """Last-token prefill logits within 1e-5 of ``jax.jit(lm.prefill)``
    with frames, every cache leaf (the self K/V, the cross K/V) likewise,
    the cross length and the length."""
    rp, tp = ((pair.params, pair.tparams) if which == "adapter"
              else (pair.merged, pair.tmerged))
    r_logits, r_cache = jax.jit(pair.rlm.prefill)(
        rp, {"tokens": jnp.asarray(pair.prompts),
             "src": jnp.asarray(pair.src)})
    t_logits, t_cache = pair.tlm.prefill(
        tp, {"tokens": torch.from_numpy(pair.prompts),
             "src": torch.from_numpy(pair.src)})
    _rel(t_logits.numpy(), r_logits, "logits")
    got, want = dict(_flat(t_cache["layers"])), dict(_flat(r_cache["layers"]))
    assert set(got) == set(want)
    for k in want:
        if k == "cross/len":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            _rel(got[k].numpy(), want[k], k)
    np.testing.assert_array_equal(t_cache["len"].numpy(), r_cache["len"])


@pytest.mark.parametrize("frames", ("src", "src_less"))
def test_greedy_tokens_identical_to_reference(pair, frames):
    """With frames, the static path (prefill, merge into a decode cache
    holding the frames' cross K/V, greedy decode) gives the reference's
    ``merge_prefill_cache`` + ``generate`` tokens, on the adapter tree and
    the merged one; without, the per-token loop over a zero cross memory
    gives the reference's ``generate_loop_reference``."""
    max_len = PROMPT + GEN_LEN
    for rp, tp in ((pair.params, pair.tparams), (pair.merged, pair.tmerged)):
        if frames == "src_less":
            want, _ = rserve.generate_loop_reference(pair.rlm, rp,
                                                     pair.prompts, GEN_LEN,
                                                     max_len)
            got, _ = tserve.generate_loop_reference(pair.tlm, tp,
                                                    pair.prompts, GEN_LEN,
                                                    max_len, device="cpu")
        else:
            logits, pre = jax.jit(pair.rlm.prefill)(
                rp, {"tokens": jnp.asarray(pair.prompts),
                     "src": jnp.asarray(pair.src)})
            cache = pair.rlm.merge_prefill_cache(
                pre, pair.rlm.slot_state().init(2, max_len, jnp.float32,
                                                src_cap=SRC))
            want, _ = pair.rlm.generate(rp, cache, logits, GEN_LEN)
            got, _ = tserve.generate(pair.tlm, tp, pair.prompts, GEN_LEN,
                                     max_len, device="cpu", src=pair.src)
        np.testing.assert_array_equal(got, np.asarray(want))


def _serve(mod, lm, tree, trace, srcs, **kw):
    eng = mod.ContinuousEngine(lm, tree, max_src=MAX_SRC, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid,
                   src=srcs[r.rid])
    return eng.run(), eng


def _static_alone(pair, r, src, max_len):
    """One request alone through the port's static path (prefill with its
    frames + greedy decode; without frames the per-token loop, whose cache
    ``init_cache`` splits in half: given twice ``max_len``, it holds
    ``max_len`` decoder positions, as the engine's slots do)."""
    if src is None:
        toks, _ = tserve.generate_loop_reference(
            pair.tlm, pair.tmerged, r.prompt[None], r.max_new_tokens,
            2 * max_len, device="cpu")
    else:
        toks, _ = tserve.generate(pair.tlm, pair.tmerged, r.prompt[None],
                                  r.max_new_tokens, max_len, device="cpu",
                                  src=src[None])
    return [int(t) for t in toks[0]]


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
@pytest.mark.parametrize("name", sorted(TRACES))
def test_engine_streams_match_reference(pair, name, layout):
    """Each of ``tests/test_serving_encdec.py``'s traces (mixed prompt,
    generation and source lengths with a src-less request refilling a
    slot whose last occupant had frames; two slots with different
    memories decoding together; the fast lane's) through the port's
    engine equals the reference's ``ContinuousEngine(max_src=8)``, stream
    for stream, contiguous and paged (self K/V in pages of 4); each
    stream equals its request served alone through the port's static
    path; the cross lengths left are the admitted memories'."""
    trace_kw, src_lens, ekw = TRACES[name]
    trace = serving.make_trace(**trace_kw, vocab=pair.rcfg.vocab)
    srcs = {r.rid: _src(pair.rcfg, ss, 100 + r.rid)
            for r, ss in zip(trace, src_lens)}
    kw = dict(ekw, page_size=4 if layout == "paged" else 0)
    want, _ = _serve(rserving, pair.rlm, pair.merged, trace, srcs, **kw)
    got, eng = _serve(serving, pair.tlm, pair.tmerged, trace, srcs, **kw)
    assert got == want and sorted(got) == [r.rid for r in trace]
    for r in trace:
        assert got[r.rid] == _static_alone(pair, r, srcs[r.rid],
                                           ekw["max_len"]), r.rid
    if name == "two_slots_two_memories":
        assert sorted(eng.cache["layers"]["cross"]["len"].tolist()) == \
            [3, 6]


def test_encode_captures_are_bucketed(pair):
    """The encoder's capture budget is the reference's compile budget,
    bit_length(max_src) (+1 when max_src is not a power of two); with a
    stand-in capture, 16 requests of 16 distinct source lengths on a
    ``max_src=16`` engine capture only the power-of-two buckets {1, 2, 4,
    8, 16}, within the budget the engine declares to a ``CompileGuard``."""
    assert [src_buckets(m) for m in (1, 8, 16, 100, 128)] == [1, 4, 5, 8, 8]
    with port_guard.CompileGuard("encdec-pin") as guard:
        eng = serving.ContinuousEngine(pair.tlm, pair.tmerged, n_slots=2,
                                       max_len=12, prefill_chunk=4,
                                       decode_burst=2, max_src=16)
        stand_in(eng)
        for ss in range(1, 17):
            eng.submit(np.arange(4, 7, dtype=np.int32), 2, rid=ss,
                       src=_src(pair.rcfg, ss, 40 + ss))
        out = eng.run()
        assert len(out) == 16
        guard.check()
        count, budget = guard.counts()["engine.encode"]
        assert budget == 5 and count == 5
    assert set(k[1] for k in eng.graphs["encode"].graphs) == {1, 2, 4, 8, 16}


def test_slot_state_layout_reset_and_clear(pair):
    """The layout is the reference's (shapes and dtypes, contiguous and
    paged, with a bf16 cache dtype, and the split of an ``init`` without
    a source capacity); both packages allow rollback (the cross cache is
    frozen); ``reset`` zeroes a refilled slot's cross K/V and cross
    length and keeps its self K/V rows and the other slot's everything;
    ``clear`` zeroes all."""
    for ps, n_pages, src_cap in ((0, 0, 8), (4, 9, 8), (0, 0, None)):
        r = pair.rlm.slot_state(ps, n_pages).init(2, 16, dtype=jnp.bfloat16,
                                                  src_cap=src_cap)
        t = SlotState(pair.tcfg, ps, n_pages).init(
            2, 16, dtype=torch.bfloat16, device="cpu", src_cap=src_cap)
        rl, tl = dict(_flat(r)), dict(_flat(t))
        assert set(rl) == set(tl)
        for k in rl:
            assert tuple(tl[k].shape) == rl[k].shape, k
            assert str(tl[k].dtype).split(".")[-1] == str(rl[k].dtype), k
    assert pair.rlm.slot_state().supports_rollback()
    assert SlotState(pair.tcfg).supports_rollback()
    ss = SlotState(pair.tcfg)
    cache = ss.init(2, 16, dtype=torch.float32, device="cpu", src_cap=8)
    for _, t in _flat(cache):
        t.copy_(torch.randn(t.shape) + 1 if t.is_floating_point()
                else torch.full(t.shape, 7, dtype=t.dtype))
    before = {k: v.clone() for k, v in _flat(cache)}
    states = {id(t) for t in ss.state_leaves(cache)}
    assert states == {id(cache["layers"]["cross"][k]) for k in ("k", "v")}
    ss.reset(cache, torch.tensor([True, False]))
    for k, v in _flat(cache):
        ax = 0 if k.endswith("len") else 1
        old = before[k]
        np.testing.assert_array_equal(v.select(ax, 1).numpy(),
                                      old.select(ax, 1).numpy())
        if k.startswith("layers/self"):
            np.testing.assert_array_equal(v.select(ax, 0).numpy(),
                                          old.select(ax, 0).numpy())
        else:
            assert not v.select(ax, 0).any(), k
    ss.clear(cache)
    assert not any(v.any() for _, v in _flat(cache))


REFUSALS = {
    # (engine arguments, submit arguments, exception, reason)
    "tenants": ("adapters", None, NotImplementedError,
                "adapter serving: the encdec encoder runs outside"),
    "speculation": (dict(speculate=2, decode_burst=1, drafter="*=intq8"),
                    None, NotImplementedError,
                    "encdec drafters would need their own"),
    "too_many_frames": ({}, dict(ss=5, d=0), ValueError, "max_src=4"),
    "wrong_width": ({}, dict(ss=3, d=1), ValueError, "d_model"),
    "zero_frames": ({}, dict(ss=0, d=0), ValueError, "zero frames")}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_with_the_references_reasons(pair, case):
    """Tenants and speculation over encdec are refused at construction,
    and frames beyond ``max_src``, of the wrong width or none (a [0, d]
    array) at submit, each with the reference's words, in both
    packages."""
    ekw, skw, exc, match = REFUSALS[case]
    for mod, lm, tree in ((rserving, pair.rlm, pair.merged),
                          (serving, pair.tlm, pair.tmerged)):
        if ekw == "adapters":
            store = mod.AdapterStore(tree, capacity=2)
            with pytest.raises(exc, match=match):
                mod.ContinuousEngine(lm, tree, n_slots=1, max_len=8,
                                     adapters=store)
            continue
        if skw is None:
            with pytest.raises(exc, match=match):
                mod.ContinuousEngine(lm, tree, n_slots=1, max_len=8, **ekw)
            continue
        eng = mod.ContinuousEngine(lm, tree, n_slots=1, max_len=8,
                                   max_src=4)
        with pytest.raises(exc, match=match):
            eng.submit(np.arange(4, 6, dtype=np.int32), 2,
                       src=np.zeros((skw["ss"], pair.rcfg.d_model
                                     + skw["d"]), np.float32))
        eng.submit(np.arange(4, 6, dtype=np.int32), 2, src=None)


def test_src_refused_for_another_family():
    """Frames for a gqa model are refused with the reference's words, in
    both packages; ``max_src`` is ignored there, as in the reference."""
    for mod, cfg, lmc in ((rserving, RC.reduced("gemma3-1b"), RLM),
                          (serving, TC.reduced("gemma3-1b"), TLM)):
        lm = lmc(cfg)
        if mod is rserving:
            tree = RS.merge_tree(lm.init(jax.random.PRNGKey(0)))
        else:
            tree = tserve.merge_model(lm.init(torch.Generator(), "cpu"))
        eng = mod.ContinuousEngine(lm, tree, n_slots=1, max_len=8,
                                   max_src=8)
        assert eng.max_src == 0
        with pytest.raises(ValueError, match="encdec request field"):
            eng.submit(np.arange(4, 6, dtype=np.int32), 2,
                       src=np.zeros((2, cfg.d_model), np.float32))


def test_frontend_recovers_as_the_reference(pair):
    """``ServingFrontend`` over each package's engine with frames (the
    mixed trace's, a src-less request among them) through a crash and a
    NaN: tickets (status, tokens, recoveries), the injector's log and the
    engines' counters equal the reference's, and every recovered stream
    is the clean run's (a recovered request is resubmitted with its
    frames)."""
    trace_kw, src_lens, ekw = TRACES["mixed_with_src_less_refill"]
    trace = serving.make_trace(**trace_kw, vocab=pair.rcfg.vocab)
    srcs = {r.rid: _src(pair.rcfg, ss, 100 + r.rid)
            for r, ss in zip(trace, src_lens)}
    got = {}
    for side, mod, rt, lm, tree in (
            ("ref", rserving, rruntime, pair.rlm, pair.merged),
            ("port", serving, runtime, pair.tlm, pair.tmerged)):
        inj = rt.FaultInjector(seed=0, crash_steps=(3,), nan_steps=(6,))
        fe = mod.ServingFrontend(lm, tree, **ekw, queue_cap=len(trace),
                                 injector=inj, max_src=MAX_SRC)
        for r in trace:
            fe.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id, rid=r.rid,
                      src=srcs[r.rid])
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
    clean, _ = _serve(serving, pair.tlm, pair.tmerged, trace, srcs, **ekw)
    assert {t.rid: list(t.tokens) for t in fe.tickets.values()} == clean


def _batch(seed=1, b=3, s=16, ss=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 256, size=(b, s)).astype(np.int32)
    labs = rng.integers(-1, 256, size=(b, s)).astype(np.int32)
    labs[1] = -1
    src = (rng.normal(size=(b, ss, 64)) * 0.3).astype(np.float32)
    return toks, labs, src


@pytest.fixture(scope="module")
def ref_grads(pair):
    toks, labs, src = _batch()
    trainable, frozen = split_params(pair.params)

    def loss_fn(tr):
        return pair.rlm.loss(merge_params(tr, frozen),
                             {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labs),
                              "src": jnp.asarray(src)})
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable)
    return r_loss, r_m, ref_adapters(r_grads)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_and_grads_match_reference(pair, ref_grads, remat):
    """The loss and xent within 1e-5 of ``jax.value_and_grad`` of the
    reference's ``LM.loss`` with frames, and every adapter's gradient (the
    encoder's, the decoder's self- and cross-attention's, whose wk and wv
    reach the loss through the memory) finite and within 1e-5 of its
    tensor's largest, with and without remat."""
    r_loss, r_m, want = ref_grads
    tcfg = TC.reduced(ARCH, remat=remat)
    tlm, tparams = TLM(tcfg), bridge.load_numpy_tree(pair.tree, tcfg, "cpu")
    toks, labs, src = _batch()
    tr = TS.trainable_tensors(tparams)
    t_loss, t_m = tlm.loss(tparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labs),
                                     "src": torch.from_numpy(src)})
    grads = torch.autograd.grad(t_loss, list(tr.values()))
    _close(t_loss.detach().numpy(), np.asarray(r_loss), where="loss")
    _close(t_m["xent"].detach().numpy(), np.asarray(r_m["xent"]),
           where="xent")
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _close(bridge.adapters_numpy(tparams, dict(zip(tr, grads))), want)


def test_train_cli_step_matches_make_train_fn(pair):
    """One step of ``train --arch seamless-m4t-medium --reduced --device
    cpu`` over the reference's tree against ``jax.jit(make_train_fn)`` on
    the reference driver's split of the stream's batch (the first half of
    each sequence its tokens and labels, as many frames its source: the
    port's seeded frames, given to both): loss, xent and grad_norm within
    1e-5, the moments within 1e-5 / 2e-5, every adapter within the Adam
    allowance."""
    from test_torch_train import _adam_allowance
    from repro_torch.optim import AdamWConfig
    seq = 32
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
            "--seq-len", str(seq), "--global-batch", "2", "--lr", "2e-4"]
    args = ttrain.build_parser().parse_args(argv)
    tparams = bridge.load_numpy_tree(pair.tree, pair.tcfg, "cpu")
    res = ttrain.run(ttrain.setup(args, params=tparams), args)
    toks, labs = ref_stream("alpaca", vocab=256, seq_len=seq,
                            global_batch=2).next_batch()
    half = seq // 2
    tb = ttrain.train_batch(pair.tcfg, toks, labs, torch.device("cpu"))
    assert tb["src"].shape == (2, half, pair.rcfg.d_model)
    np.testing.assert_array_equal(tb["tokens"].numpy(), toks[:, :half])
    batch = {"tokens": jnp.asarray(toks[:, :half]),
             "labels": jnp.asarray(labs[:, :half]),
             "src": jnp.asarray(tb["src"].numpy())}
    r_tr, r_fr = split_params(pair.params)
    r_opt = ref_adamw_init(r_tr)
    r_tr, r_opt, r_m = jax.jit(ref_train_fn(pair.rlm, RAdamW(
        lr=2e-4, schedule="constant")))(r_tr, r_fr, r_opt, batch)
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


def test_train_batch_frames_are_seeded_by_the_batch():
    """``train_batch``'s encdec source: the same frames for the same
    tokens (a resumed run's batch, the CPU's side of a card step), other
    frames for other tokens, at the embeddings' scale and never zero (the
    reference driver's zero frames make the encoder's activations 0)."""
    cfg = TC.reduced(ARCH)
    toks, labs = ref_stream("alpaca", vocab=256, seq_len=32,
                            global_batch=2).next_batch()
    a = ttrain.train_batch(cfg, toks, labs, torch.device("cpu"))["src"]
    b = ttrain.train_batch(cfg, toks.copy(), labs, "cpu")["src"]
    c = ttrain.train_batch(cfg, toks[::-1].copy(), labs, "cpu")["src"]
    assert a.shape == (2, 16, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(a.std().item() - ttrain.FRAME_STD) < 0.1 * ttrain.FRAME_STD


def test_bridge_roundtrips_the_tree(pair):
    """``numpy_tree`` of the loaded port tree gives the reference's tree
    back (the encoder and decoder stacks, the decoder's cross attention
    and third norm, ``enc_ln``), and ``load_adapters`` of its adapters is
    exact."""
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


CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "2",
       "--prompt-len", "8", "--gen-len", "5"]


@pytest.mark.parametrize("engine", ("static", "continuous", "frontend"))
def test_serve_cli(pair, engine, monkeypatch, capsys):
    """``serve --arch seamless-m4t-medium --reduced --device cpu``: the
    static token-only demo decodes through the per-token loop over a zero
    cross memory, as the reference's CLI does, with its tokens, and
    ``--verify`` holds the merge within bound; the continuous engine and
    the frontend serve the same requests src-less; ``--adapters`` and
    ``--speculate`` are refused with the reference's reasons."""
    monkeypatch.setattr(tserve, "build_model",
                        lambda cfg, device, seed=0, bump=True:
                        (pair.tlm, pair.tparams, pair.tmerged))
    prompts = np.random.default_rng(0).integers(
        4, pair.rcfg.vocab, size=(2, 8)).astype(np.int32)
    if engine == "static":
        res = tserve.main(CLI + ["--verify"])
        want, _ = rserve.generate_loop_reference(pair.rlm, pair.merged,
                                                 prompts, 5, 13)
        np.testing.assert_array_equal(res["tokens"], np.asarray(want))
        assert all(r["rel"] <= res["merge_bound_rel"]
                   for r in res["merge_check"].values())
        return
    res = tserve.main(CLI + ["--engine", engine])
    assert res["tokens"].shape == (2, 5) if engine == "continuous" else \
        len(res["tokens"]) == 2
    for extra, match in ((["--adapters", "a=demo:1"], "encdec encoder"),
                         (["--speculate", "2"], "encdec drafters")):
        with pytest.raises(SystemExit):
            tserve.main(CLI + ["--engine", engine, *extra])
        assert match in capsys.readouterr().err


def test_train_cli_cut_and_resumed_equals_uninterrupted(tmp_path):
    """The train CLI on seamless-m4t-medium (the reference driver's
    split), cut at step 2 and resumed: losses, adapters and moments equal
    the uninterrupted run's bit for bit."""
    from test_torch_recurrent import (_cut_and_resumed,
                                      assert_resumed_bit_for_bit)
    assert_resumed_bit_for_bit(*_cut_and_resumed(ARCH, tmp_path))
