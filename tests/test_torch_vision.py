"""Parity of the port's pixtral-12b vision stub with the JAX package, on
the CPU at ``reduced("pixtral-12b")`` (2 layers, d 64, frontend_len 8,
f32): patch embeddings ``batch["frontend"]`` prepended to the token
embeddings in the prefill (logits, caches and the cache length), the
greedy tokens decoded after it, the loss (patch positions unsupervised)
and its adapter gradients, one train step through ``launch/train.py``
on the reference driver's split of a stream batch (zero patches in
place of the first frontend_len positions), the ``--seq-len`` refusal,
and a config without a frontend computing what it computed before.

The reference tree from ``LM.init`` (adapters nudged by +0.01) goes to
the port through numpy and ``repro_torch.bridge``; the reference runs
without a mesh.  Tolerances: 1e-5 absolute on logits and caches (as
tests/test_torch_families.py), 1e-5 of each tensor's largest magnitude
on the loss and gradients (as tests/test_torch_train.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.data import make_stream as ref_stream  # noqa: E402
from repro.launch.steps import make_train_fn as ref_train_fn  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import merge_params, split_params  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from _torch_parity import bump, numpy_tree, ref_adapters  # noqa: E402
from test_torch_train import _adam_allowance, _close, _moments  # noqa: E402

ARCH = "pixtral-12b"
TOL = 1e-5
B, S = 2, 24          # 8 patch rows + 24 tokens: two xent chunks of 16
GEN_LEN = 5
LR = 2e-4
TRAIN_ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq-len",
              "32", "--global-batch", "2", "--dataset", "alpaca", "--lr",
              str(LR), "--log-every", "1"]


@pytest.fixture(scope="module")
def pair():
    rcfg, tcfg = RC.reduced(ARCH), TC.reduced(ARCH)
    rlm = RLM(rcfg)
    params = bump(rlm.init(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    rng = np.random.default_rng(0)
    return SimpleNamespace(
        rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg), params=params,
        merged=merged, tree=numpy_tree(params),
        tparams=bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        prompts=rng.integers(4, rcfg.vocab, size=(B, S)).astype(np.int32),
        patches=rng.standard_normal(
            (B, rcfg.frontend_len, rcfg.d_model)).astype(np.float32),
        labels=rng.integers(-1, rcfg.vocab, size=(B, S)).astype(np.int32))


def _rbatch(pair, labels=False):
    out = {"tokens": jnp.asarray(pair.prompts),
           "frontend": jnp.asarray(pair.patches)}
    if labels:
        out["labels"] = jnp.asarray(pair.labels)
    return out


def _tbatch(pair, labels=False):
    out = {"tokens": torch.from_numpy(pair.prompts),
           "frontend": torch.from_numpy(pair.patches)}
    if labels:
        out["labels"] = torch.from_numpy(pair.labels)
    return out


def test_pixtral_is_registered_with_the_reference_fields():
    cfg = TC.get(ARCH)
    assert (cfg.frontend, cfg.frontend_len, cfg.family) == ("vision", 256,
                                                            "gqa")
    assert TC.reduced(ARCH).frontend_len == RC.reduced(ARCH).frontend_len == 8
    assert ARCH in TC.REGISTRY


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_with_patches_matches_reference(pair, which):
    """Last-token logits and the caches within 1e-5 of
    ``jax.jit(lm.prefill)`` on the same patches and tokens; the cache
    holds frontend_len + S rows and its length counts them."""
    rp = pair.params if which == "adapter" else pair.merged
    tp = pair.tparams if which == "adapter" else pair.tmerged
    r_logits, r_cache = jax.jit(pair.rlm.prefill)(rp, _rbatch(pair))
    t_logits, t_cache = pair.tlm.prefill(tp, _tbatch(pair))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                               atol=TOL, rtol=0)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            t_cache["layers"][leaf].numpy(),
            np.asarray(r_cache["layers"][leaf]), atol=TOL, rtol=0)
    f = pair.rcfg.frontend_len
    assert t_cache["layers"]["k"].shape[2] == f + S
    np.testing.assert_array_equal(t_cache["len"].numpy(),
                                  np.asarray(r_cache["len"]))
    assert t_cache["len"].tolist() == [f + S] * B


def test_prefill_all_puts_the_patch_rows_first(pair):
    """Every position's logits: there are frontend_len + S of them, and
    the last is ``prefill``'s within 1e-5 (the head runs on other row
    counts, so the sums may round apart)."""
    every, _ = pair.tlm.prefill_all(pair.tmerged, _tbatch(pair))
    last, _ = pair.tlm.prefill(pair.tmerged, _tbatch(pair))
    assert every.shape == (B, pair.rcfg.frontend_len + S, pair.rcfg.vocab)
    torch.testing.assert_close(every[:, -1], last, atol=TOL, rtol=0)


def test_greedy_tokens_after_patches_identical_to_reference(pair):
    """The static path with patches (prefill, the cache merged into a
    decode cache of frontend_len + S + GEN_LEN rows, greedy decode)
    gives the reference's ``merge_prefill_cache`` + ``generate``
    tokens."""
    max_len = pair.rcfg.frontend_len + S + GEN_LEN
    logits, pre = jax.jit(pair.rlm.prefill)(pair.merged, _rbatch(pair))
    cache = pair.rlm.merge_prefill_cache(
        pre, pair.rlm.init_cache(B, max_len, dtype=jnp.float32))
    r_gen, _ = pair.rlm.generate(pair.merged, cache, logits, GEN_LEN)
    run = tserve.make_graph_generator(pair.tlm, pair.tmerged, (B, S),
                                      GEN_LEN, max_len, device="cpu")
    t_gen, _ = run(pair.prompts, frontend=pair.patches)
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))
    # the patches matter: zero patches decode otherwise
    zeros, _ = run(pair.prompts, frontend=np.zeros_like(pair.patches))
    assert not np.array_equal(zeros, t_gen)


def test_merge_check_with_patches_holds_the_merge(pair):
    max_len = pair.rcfg.frontend_len + S + 1
    check = tserve.merge_check(pair.tlm, pair.tparams, pair.tmerged,
                               pair.prompts, max_len, device="cpu",
                               frontend=pair.patches)
    assert all(r["rel"] <= tserve.merge_bound(pair.tcfg)
               for r in check.values())


def _ref_loss_and_grads(pair):
    trainable, frozen = split_params(pair.params)

    def loss_fn(tr):
        return pair.rlm.loss(merge_params(tr, frozen),
                             _rbatch(pair, labels=True))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable)
    return loss, metrics, ref_adapters(grads)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_and_gradients_match_reference(pair, remat):
    """The loss, its xent and every adapter gradient within 1e-5 of
    ``jax.value_and_grad`` of the reference's ``LM.loss`` on the same
    patches, tokens and labels."""
    tlm = TLM(pair.tcfg.scaled(remat=remat))
    tparams = bridge.load_numpy_tree(pair.tree, pair.tcfg, "cpu")
    r_loss, r_m, r_grads = _ref_loss_and_grads(pair)
    trainable = TS.trainable_tensors(tparams)
    loss, m = tlm.loss(tparams, _tbatch(pair, labels=True))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    _close(loss.detach().numpy(), np.asarray(r_loss), where="loss")
    _close(m["xent"].detach().numpy(), np.asarray(r_m["xent"]),
           where="xent")
    _close(bridge.adapters_numpy(tparams, dict(zip(trainable, grads))),
           r_grads)


def test_patch_positions_carry_no_loss(pair):
    """The loss is the mean cross-entropy of the token positions alone:
    the prefill's logits at positions frontend_len.. against the labels
    (the patch rows get label -1)."""
    batch = _tbatch(pair, labels=True)
    with torch.no_grad():
        loss, _ = pair.tlm.loss(pair.tparams, batch)
        logits, _ = pair.tlm.prefill_all(pair.tparams, batch)
    f = pair.rcfg.frontend_len
    labels = batch["labels"].to(torch.int64)
    keep = labels >= 0
    lse = torch.logsumexp(logits[:, f:], dim=-1)
    ll = logits[:, f:].gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    want = ((lse - ll) * keep).sum() / keep.sum()
    _close(loss.numpy(), want.numpy(), where="token positions only")


def _reference_step(pair, args):
    """The reference driver's first step on the same stream batch, split
    as ``repro.launch.train`` splits a vision config's batch."""
    rlm = RLM(RC.reduced(ARCH))
    stream = ref_stream(args.dataset, vocab=pair.rcfg.vocab,
                        seq_len=args.seq_len, global_batch=args.global_batch)
    toks, labs = stream.next_batch()
    f = pair.rcfg.frontend_len
    batch = {"tokens": jnp.asarray(toks)[:, f:],
             "labels": jnp.asarray(labs)[:, f:],
             "frontend": jnp.zeros((toks.shape[0], f, pair.rcfg.d_model),
                                   pair.rcfg.quant.dtype)}
    r_tr, r_fr = split_params(pair.params)
    r_opt = ref_adamw_init(r_tr)
    step = jax.jit(ref_train_fn(rlm, RAdamW(lr=LR, schedule="constant")))
    new_tr, new_opt, metrics = step(r_tr, r_fr, r_opt, batch)
    return new_tr, new_opt, metrics


def test_train_cli_step_on_a_vision_batch_matches_reference(pair):
    """``launch/train.py``'s ``setup`` and ``run`` for one step over the
    reference's weights: the batch split (zero patches, the tokens and
    labels past frontend_len) and the step's loss, grad norm, moments and
    updated adapters equal the reference driver's step within the
    tolerances of tests/test_torch_train.py."""
    args = ttrain.build_parser().parse_args(TRAIN_ARGV + ["--steps", "1"])
    tparams = bridge.load_numpy_tree(pair.tree, pair.tcfg, "cpu")
    st = ttrain.setup(args, params=tparams)
    res = ttrain.run(st, args)
    new_tr, new_opt, r_m = _reference_step(pair, args)
    _close(np.float64(res["loss"][0]), np.asarray(r_m["loss"]),
           where="loss")
    _close(np.float64(res["grad_norm"][0]), np.asarray(r_m["grad_norm"]),
           where="grad_norm")
    moments = [_moments(st.params, st.opt_state, new_opt)]
    _close(bridge.adapters_numpy(st.params), ref_adapters(new_tr),
           allow=_adam_allowance(moments, AdamWConfig(lr=LR)))


def test_prefill_refuses_positions_off_the_chunk_grid_as_the_reference(pair):
    """Patch rows + tokens must be a multiple of the prefill's chunk_q
    (16 reduced, 256 full) when they exceed it, in both packages: 8 + 16
    = 24 positions are refused (so a full pixtral prompt after its 256
    patch rows is 256 tokens, not 128)."""
    toks = np.zeros((B, 16), np.int32)
    batch = {"tokens": toks, "frontend": pair.patches}
    with pytest.raises(AssertionError):
        pair.rlm.prefill(pair.merged, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with pytest.raises(AssertionError):
        pair.tlm.prefill(pair.tmerged, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})


def test_train_setup_trains_a_given_config():
    """``setup(args, cfg=...)`` builds and trains that config (narrower
    than the flags' own), the flags' other settings standing."""
    args = ttrain.build_parser().parse_args(TRAIN_ARGV + ["--steps", "1"])
    narrow = ttrain.build_config(args).scaled(d_ff=32)
    st = ttrain.setup(args, cfg=narrow)
    up = TS.quantized_base(st.params.blocks[0]["mlp"]["up"])
    assert st.cfg is narrow and up.d_out == 32
    res = ttrain.run(st, args)
    assert np.isfinite(res["loss"]).all() and res["end"] == 1


def test_train_batch_splits_a_vision_batch_as_the_reference():
    cfg = TC.reduced(ARCH)
    toks = np.arange(2 * 32, dtype=np.int32).reshape(2, 32)
    labs = toks + 1
    batch = ttrain.train_batch(cfg, toks, labs, "cpu")
    f = cfg.frontend_len
    np.testing.assert_array_equal(batch["tokens"].numpy(), toks[:, f:])
    np.testing.assert_array_equal(batch["labels"].numpy(), labs[:, f:])
    assert batch["frontend"].shape == (2, f, cfg.d_model)
    assert batch["frontend"].dtype == cfg.quant.dtype
    assert not batch["frontend"].any()
    plain = ttrain.train_batch(TC.reduced("llama7b-proxy"), toks, labs, "cpu")
    assert set(plain) == {"tokens", "labels"}
    np.testing.assert_array_equal(plain["tokens"].numpy(), toks)


@pytest.mark.parametrize("seq_len", ("8", "4"))
def test_seq_len_not_past_frontend_len_is_refused(seq_len):
    with pytest.raises(ValueError, match="frontend_len"):
        ttrain.main(TRAIN_ARGV + ["--steps", "1", "--seq-len", seq_len])


def test_train_meta_refuses_a_checkpoint_of_another_frontend():
    cfg = TC.reduced(ARCH)
    tlm = TLM(cfg)
    params = tlm.init(torch.Generator().manual_seed(0), "cpu")
    meta = ttrain.train_meta(cfg, params, 0, "cpu")
    assert (meta["frontend"], meta["frontend_len"]) == ("vision", 8)
    other = ttrain.train_meta(cfg.scaled(frontend_len=4), params, 0, "cpu")
    assert ttrain.meta_mismatch(other, meta) == [
        "frontend_len: checkpoint 4, model 8"]


@pytest.mark.parametrize("arch", ("llama7b-proxy", ARCH))
def test_text_only_batch_computes_what_it_did_before(arch):
    """Without patches (a config with no frontend, or pixtral given text
    alone, as ``serve`` gives it) the prefill is the token embeddings
    through the trunk, bit for bit, and a stray ``frontend`` key is
    ignored by a config without a frontend."""
    cfg = TC.reduced(arch)
    tlm = TLM(cfg)
    params = tlm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        4, cfg.vocab, size=(B, 32)).astype(np.int32))
    with torch.no_grad():
        x = params.embed[toks.to(torch.int64)]
        h, cache = tlm._trunk(params, x, collect_cache=True)
        want = tlm._logits(params, rmsnorm(params.final_ln, h,
                                           cfg.norm_eps)[:, -1:])[:, 0]
        got, pre = tlm.prefill(params, {"tokens": toks})
    assert torch.equal(got, want)
    assert torch.equal(pre["layers"]["k"], cache["k"])
    assert pre["len"].tolist() == [32] * B
    if cfg.frontend is None:
        stray = torch.ones((B, 8, cfg.d_model))
        with torch.no_grad():
            again, _ = tlm.prefill(params, {"tokens": toks,
                                            "frontend": stray})
        assert torch.equal(again, want)
