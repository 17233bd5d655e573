"""Parity of the port's QA-LoRA fine-tuning with the JAX package, on the
CPU, at reduced sizes, in f32.

The reference tree from ``LM.init`` (adapters nudged by +0.01, so every
gradient is nonzero) goes to the port through
``repro_torch.bridge.load_numpy_tree``.  The reference runs with no mesh:
``LM.loss`` and ``jax.jit(make_train_fn(...))`` (its train driver runs
under a mesh, which this jax rejects; see ROADMAP.md).  Loss, gradients,
updated adapters and AdamW moments must agree within 1e-5 of each
tensor's largest magnitude; the merged results of the same trained
adapters must give identical greedy tokens.
"""

import os
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
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_fn  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, split_params as tsplit  # noqa: E402
from _torch_parity import (bump, numpy_tree, ref_adapters,  # noqa: E402
                           with_adapters)

ARCHS = ("gemma3-1b", "llama7b-proxy")
REL = 1e-5
SEQ, BATCH = 32, 3
LR = 2e-4


def _close(got, ref, rel=REL, where="", allow=None):
    """Every leaf of ``got`` within ``rel`` of its reference leaf's largest
    magnitude (nested dicts of arrays, same keys), plus ``allow`` (a tree
    of per-element allowances) where given."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (where, sorted(got), sorted(ref))
        for k in ref:
            _close(got[k], ref[k], rel, f"{where}/{k}",
                   None if allow is None else allow[k])
        return
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (where, got.shape, ref.shape)
    bound = rel * max(np.abs(ref).max(), 1e-30) + (
        0.0 if allow is None else np.asarray(allow, np.float64))
    err = np.abs(got - ref)
    i = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), \
        f"{where}: |diff| {err[i]:.3e} > {np.broadcast_to(bound, err.shape)[i]:.3e} at {i}"


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*(np.asarray(t, np.float64) for t in trees))


def _moments(tparams, t_opt, r_opt):
    """((mu, nu) of the port, (mu, nu) of the reference) in the
    ``adapters_numpy`` layout, after checking that they agree."""
    port = tuple(bridge.adapters_numpy(tparams, t_opt[k]) for k in ("mu", "nu"))
    ref = tuple(ref_adapters(r_opt[k]) for k in ("mu", "nu"))
    for k, got, want in zip(("mu", "nu"), port, ref):
        _close(got, want, where=k)
    assert int(t_opt["step"]) == int(r_opt["step"])
    return port, ref


def _adam_allowance(moments, cfg):
    """How far apart two AdamW trajectories' parameters may drift through
    the update map u = m_hat / (sqrt(v_hat) + eps) alone, when their
    moments agree within the test's tolerance: per step, to first order,
    lr (|dm| / (sqrt(v) + eps) + |m| |d sqrt(v)| / (sqrt(v) + eps)^2) on
    the bias-corrected moments (v the smaller of the two).  Near g = 0 the
    map's slope is 1 / eps (Adam's first step gives g / (|g| + eps)), so an
    element whose gradient is within ~eps of zero may move by up to 2 lr
    while its gradient agrees within 1e-5 of the tensor's largest.
    ``moments`` lists :func:`_moments` after each step."""
    total = None
    for t, ((mu_p, nu_p), (mu_r, nu_r)) in enumerate(moments, 1):
        c1, c2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t

        def one(mp, mr, vp, vr):
            den = np.sqrt(np.minimum(vp, vr) / c2) + cfg.eps
            dm = np.abs(mp - mr) / c1
            dv = np.abs(np.sqrt(vp / c2) - np.sqrt(vr / c2))
            return cfg.lr * (dm / den + np.abs(mr / c1) * dv / den ** 2)
        step = _tree_map(one, mu_p, mu_r, nu_p, nu_r)
        total = step if total is None else _tree_map(np.add, total, step)
    return total


def _batch(seed=0, masked_row=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 256, size=(BATCH, SEQ)).astype(np.int32)
    labs = rng.integers(-1, 256, size=(BATCH, SEQ)).astype(np.int32)
    if masked_row:
        labs[1] = -1  # a row with no supervised token
    return toks, labs


def _tbatch(toks, labs):
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}


def _rbatch(toks, labs):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    params = bump(RLM(RC.reduced(arch)).init(jax.random.PRNGKey(0)))
    return SimpleNamespace(arch=arch, params=params, tree=numpy_tree(params))


def _pair(ref, **over):
    """Reference and port models of ``ref.arch`` under ``over``, and the
    port's params loaded from the reference tree."""
    rlm = RLM(RC.reduced(ref.arch, **over))
    tcfg = TC.reduced(ref.arch, **over)
    return rlm, TLM(tcfg), bridge.load_numpy_tree(ref.tree, tcfg, "cpu")


@pytest.mark.parametrize("xent_chunk", (8, SEQ), ids=("chunked", "one_chunk"))
@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_matches_reference(ref, remat, xent_chunk):
    rlm, tlm, tparams = _pair(ref, remat=remat, xent_chunk=xent_chunk)
    toks, labs = _batch()
    r_loss, r_m = jax.jit(rlm.loss)(ref.params, _rbatch(toks, labs))
    t_loss, t_m = tlm.loss(tparams, _tbatch(toks, labs))
    assert t_loss.requires_grad
    _close(t_loss.detach().numpy(), np.asarray(r_loss))
    _close(t_m["xent"].detach().numpy(), np.asarray(r_m["xent"]))
    assert float(t_m["aux"]) == float(r_m["aux"]) == 0.0


def test_loss_of_a_fully_masked_batch_is_zero(ref):
    """No supervised token: loss_sum / max(n, 1) = 0, as in the reference."""
    rlm, tlm, tparams = _pair(ref)
    toks, labs = _batch()
    labs[:] = -1
    r_loss, _ = jax.jit(rlm.loss)(ref.params, _rbatch(toks, labs))
    t_loss, _ = tlm.loss(tparams, _tbatch(toks, labs))
    assert float(t_loss) == float(r_loss) == 0.0


def test_loss_refuses_a_sequence_not_a_multiple_of_xent_chunk(ref):
    _, tlm, tparams = _pair(ref, xent_chunk=12)
    with pytest.raises(ValueError, match="xent_chunk"):
        tlm.loss(tparams, _tbatch(*_batch()))


def _ref_grads(rlm, params, batch):
    trainable, frozen = split_params(params)

    def loss_fn(tr):
        return rlm.loss(merge_params(tr, frozen), batch)[0]
    return ref_adapters(jax.jit(jax.grad(loss_fn))(trainable))


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_train_step_matches_reference(ref, remat):
    """One step: loss, grad_norm, lr, every A and B gradient, the updated
    adapters and the AdamW moments and step."""
    rlm, tlm, tparams = _pair(ref, remat=remat)
    toks, labs = _batch(1)
    rb, tb = _rbatch(toks, labs), _tbatch(toks, labs)
    r_tr, r_fr = split_params(ref.params)
    r_opt = ref_adamw_init(r_tr)
    new_tr, new_opt, r_m = jax.jit(ref_train_fn(rlm, RAdamW(lr=LR)))(
        r_tr, r_fr, r_opt, rb)

    trainable = TS.trainable_tensors(tparams)
    loss, _ = tlm.loss(tparams, tb)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    _close(bridge.adapters_numpy(tparams, dict(zip(trainable, grads))),
           _ref_grads(rlm, ref.params, rb))

    opt = adamw_init(trainable)
    t_m = make_train_fn(tlm, AdamWConfig(lr=LR))(tparams, opt, tb)
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        _close(t_m[k].numpy(), np.asarray(r_m[k]), where=k)
    assert not t_m["loss"].requires_grad
    moments = [_moments(tparams, opt, new_opt)]
    _close(bridge.adapters_numpy(tparams), ref_adapters(new_tr),
           allow=_adam_allowance(moments, AdamWConfig(lr=LR)))
    assert opt["step"].dtype == torch.int32
    assert int(opt["step"]) == int(new_opt["step"]) == 1


def test_three_steps_on_the_stream_match_reference(ref):
    rlm, tlm, tparams = _pair(ref)
    kw = dict(vocab=256, seq_len=SEQ, global_batch=4)
    r_stream, t_stream = ref_stream("flanv2", **kw), make_stream("flanv2", **kw)
    r_tr, r_fr = split_params(ref.params)
    r_opt = ref_adamw_init(r_tr)
    r_step = jax.jit(ref_train_fn(rlm, RAdamW(lr=LR)))
    trainable, frozen = tsplit(tparams)
    t_opt = adamw_init(trainable)
    t_step = make_train_fn(tlm, AdamWConfig(lr=LR))
    moments = []
    for _ in range(3):
        toks, labs = r_stream.next_batch()
        t_toks, t_labs = t_stream.next_batch()
        np.testing.assert_array_equal(t_toks, toks)
        np.testing.assert_array_equal(t_labs, labs)
        r_tr, r_opt, r_m = r_step(r_tr, r_fr, r_opt, _rbatch(toks, labs))
        t_m = t_step(tparams, t_opt, _tbatch(t_toks, t_labs))
        _close(t_m["loss"].numpy(), np.asarray(r_m["loss"]))
        _close(t_m["grad_norm"].numpy(), np.asarray(r_m["grad_norm"]))
        moments.append(_moments(tparams, t_opt, r_opt))
    _close(bridge.adapters_numpy(tparams), ref_adapters(r_tr),
           allow=_adam_allowance(moments, AdamWConfig(lr=LR)))


def test_frozen_base_gets_no_gradient_and_stays_bit_identical(ref):
    _, tlm, tparams = _pair(ref)
    trainable, frozen = tsplit(tparams)
    before = {k: v.clone() for k, v in frozen.items()}
    assert set(trainable) == {k for k, _ in tparams.named_parameters()}
    assert all(not t.requires_grad for t in frozen.values())
    assert all(k.endswith((".a", ".b")) for k in trainable)
    assert any(".q.qweight" in k for k in frozen)
    opt = adamw_init(trainable)
    step = make_train_fn(tlm, AdamWConfig(lr=LR))
    for seed in range(2):
        step(tparams, opt, _tbatch(*_batch(seed)))
    for k, v in tparams.named_buffers():
        assert v.grad is None
        assert torch.equal(v, before[k]), k
    assert set(opt["mu"]) == set(trainable)


def test_remat_recomputes_each_adapter_linear_in_the_backward(monkeypatch):
    """With remat every qalora linear's forward (kernel 3 on the card) runs
    twice a step, without it once: the CPU counterpart of the card's
    launch counts."""
    calls = []
    real = ops.qalora_matmul_cuda

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "qalora_matmul_cuda", counting)
    for remat, per_linear in ((False, 1), (True, 2)):
        cfg = TC.reduced("llama7b-proxy", remat=remat)
        lm = TLM(cfg)
        params = lm.init(torch.Generator().manual_seed(0), "cpu")
        tr = TS.trainable_tensors(params)
        opt = adamw_init(tr)
        calls.clear()
        make_train_fn(lm, AdamWConfig())(params, opt, _tbatch(*_batch()))
        assert len(calls) == per_linear * 7 * cfg.n_layers, remat


def test_merged_trained_adapters_serve_the_reference_tokens(ref):
    """Train the port three steps, then merge its adapters in each package
    (the reference's through the reverse bridge): greedy tokens from the
    two merged models, each served with no mesh, are identical."""
    rlm, tlm, tparams = _pair(ref)
    tr = TS.trainable_tensors(tparams)
    opt = adamw_init(tr)
    step = make_train_fn(tlm, AdamWConfig(lr=1e-2))
    stream = make_stream("alpaca", vocab=256, seq_len=SEQ, global_batch=4)
    for _ in range(3):
        step(tparams, opt, _tbatch(*stream.next_batch()))
    port_merged = tserve.merge_model(tparams)
    ref_merged = RS.merge_tree(with_adapters(ref.params,
                                             bridge.adapters_numpy(tparams)))
    prompts = np.random.default_rng(3).integers(4, 256, size=(2, 6)) \
        .astype(np.int32)
    gen_len, max_len = 6, 12
    toks = jnp.asarray(prompts)
    logits, pre = jax.jit(rlm.prefill)(ref_merged, {"tokens": toks})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(2, max_len, dtype=jnp.float32))
    r_gen, _ = rlm.generate(ref_merged, cache, logits, gen_len)
    t_gen, _ = tserve.generate(tlm, port_merged, prompts, gen_len, max_len,
                               device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))
    # the trained adapters moved, so the merge is not the bump's
    before = ref_adapters(ref.params)["blocks"]["mlp"]["up"]["b"]
    after = bridge.adapters_numpy(tparams)["blocks"]["mlp"]["up"]["b"]
    assert np.abs(after - before).max() > 1e-3


TRAIN_ARGV = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
              "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "2",
              "--log-every", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """An uninterrupted 4-step run, and a run cut at step 2 then resumed."""
    whole = str(tmp_path_factory.mktemp("whole"))
    cut = str(tmp_path_factory.mktemp("cut"))
    full = ttrain.main(TRAIN_ARGV + ["--steps", "4", "--ckpt-dir", whole])
    first = ttrain.main(TRAIN_ARGV + ["--steps", "2", "--ckpt-dir", cut])
    resumed = ttrain.main(TRAIN_ARGV + ["--steps", "4", "--ckpt-dir", cut])
    return SimpleNamespace(whole=whole, cut=cut, full=full, first=first,
                           resumed=resumed)


def test_train_cli_cut_and_resumed_equals_uninterrupted(trained):
    full, first, resumed = trained.full, trained.first, trained.resumed
    assert full["start"] == 0 and full["end"] == 4
    assert resumed["start"] == 2 and resumed["steps"] == [2, 3]
    assert first["loss"] + resumed["loss"] == full["loss"]
    a, b = (r["state"].trainable for r in (full, resumed))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    for key in ("mu", "nu"):
        assert all(torch.equal(full["state"].opt_state[key][k],
                               resumed["state"].opt_state[key][k]) for k in a)
    assert tckpt.complete_steps(trained.cut) == [2, 4]
    assert tckpt.is_complete(os.path.join(trained.cut, "base"))
    assert all(np.isfinite(full["loss"])) and full["tokens_per_s"] > 0
    assert full["peak_mem_bytes"] is None  # no device memory on the CPU


def test_train_cli_refuses_another_models_checkpoint(trained):
    with pytest.raises(ValueError, match="seed"):
        ttrain.main(TRAIN_ARGV + ["--steps", "6", "--seed", "1",
                                  "--ckpt-dir", trained.whole])


def test_serve_cli_serves_a_trained_checkpoint(trained):
    out = tserve.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                       "--engine", "continuous", "--requests", "3",
                       "--prompt-len", "6", "--gen-len", "4", "--verify",
                       "--adapters", f"tuned={trained.cut},early="
                       f"{tckpt.step_path(trained.cut, 2)}"])
    assert out["tenants"] == ["tuned", "early"]
    for check in out["tenant_check"].values():
        for r in check.values():
            assert r["rel"] <= out["merge_bound_rel"]
    # the served tenant is the trained adapters over the trainer's base: its
    # merged tree's logits equal the trained model's merge
    st = trained.resumed["state"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, 256, size=(3, 6)).astype(np.int32))
    want = st.lm.prefill(tserve.merge_model(st.params), {"tokens": toks})[0]
    argmax = out["tenant_check"]["tuned"]["prefill"]["argmax"]
    assert argmax == want.argmax(-1).tolist()


def test_serve_cli_refuses_demo_beside_a_checkpoint(trained, capsys):
    """A checkpoint tenant is served over the base as initialised and a
    demo tenant over the nudged one: a list of both is refused, so that a
    demo tenant never depends on its neighbours."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                     "--engine", "continuous", "--requests", "2",
                     "--gen-len", "2", "--adapters",
                     f"tuned={trained.cut},demo=demo:1"])
    assert "do not mix" in capsys.readouterr().err


@pytest.mark.parametrize("flags,match", (
    (["--seed", "1"], "seed"),
    (["--arch", "llama7b-proxy"], "arch"),
    (["--policy", "*=int8"], "policy"),
))
def test_serve_cli_refuses_a_mismatched_checkpoint(trained, flags, match,
                                                   capsys):
    argv = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
            "--engine", "continuous", "--requests", "2", "--gen-len", "2",
            "--adapters", f"t={trained.cut}"]
    with pytest.raises(SystemExit):
        tserve.main(argv + flags)
    err = capsys.readouterr().err
    assert "was not trained against the served model" in err and match in err


def test_serve_cli_refuses_a_missing_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu", "--engine",
                     "continuous", "--adapters", f"t={tmp_path / 'none'}"])
    assert "no complete checkpoint" in capsys.readouterr().err


@pytest.mark.parametrize("flags", (["--mesh", "multipod"], ["--mesh", "pod"],
                                   ["--sync-every", "2"]))
def test_train_cli_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(TRAIN_ARGV + ["--steps", "1"] + flags)
    assert "not yet ported" in capsys.readouterr().err


def test_train_cli_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "gemma3-1b", "--reduced", "--steps", "1"])


def test_bridge_numpy_tree_roundtrips_the_port(ref):
    _, _, tparams = _pair(ref)
    again = bridge.load_numpy_tree(bridge.numpy_tree(tparams),
                                   TC.reduced(ref.arch), "cpu")
    for get in (lambda m: dict(m.named_buffers()),
                lambda m: dict(m.named_parameters())):
        a, b = get(tparams), get(again)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    _close(bridge.adapters_numpy(tparams), ref_adapters(ref.params), rel=0)
