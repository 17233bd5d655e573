"""Parity of the port's baselines and conversion with the JAX package, on
the CPU, in f32, at reduced sizes, with inputs made by numpy from a seed:
NF4, LoRA and QLoRA (``repro_torch.core.nf4`` / ``lora``), the five
linear schemes, ``convert_tree`` from a float base (RTN, a PolicyTree
target, a GPTQ closure), a quantized ``lm_head``, one ``--mode lora`` and
one ``--mode qlora`` train step, and ``serve --policy "*=qlora"``.

Tolerances: NF4 codes and absmax, RTN codes and converted base storage
are bit-identical, and so is NF4's dequantised weight; the LoRA / QLoRA
products and merges, and the scheme applies and merges, within 1e-6 of
the largest magnitude (f32 products summed in another order); converted
models' logits within 1e-5 relative (``rtol`` of tests/test_convert.py);
the quantized head's loss, the train steps' losses, gradients, moments
and updated adapters within 1e-5 (as tests/test_torch_train.py); greedy
tokens identical.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import gptq as RG  # noqa: E402
from repro.core import lora as RL  # noqa: E402
from repro.core import nf4 as RN  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.launch.steps import make_train_fn as ref_train_fn  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import split_params  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import gptq as TG  # noqa: E402
from repro_torch.core import lora as TL  # noqa: E402
from repro_torch.core import nf4 as TN  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_fn  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from _torch_parity import (bump, numpy_tree, ref_adapters,  # noqa: E402
                           with_adapters)
from test_torch_train import (LR, _adam_allowance, _batch,  # noqa: E402
                              _close, _moments, _rbatch, _ref_grads,
                              _tbatch, _tree_map)

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _near(got, ref, rel=REL, where=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (where, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (where, err)


# ---------------------------------------------------------------------------
# NF4
# ---------------------------------------------------------------------------


NF4_CASES = (((64, 96), 64), ((128, 32), 32), ((256, 64), 128),
             ((3, 64), 64), ((48, 40), 16), ((4, 8, 32), 64))


@pytest.mark.parametrize("shape,block", NF4_CASES,
                         ids=[f"{'x'.join(map(str, s))}-b{b}"
                              for s, b in NF4_CASES])
def test_nf4_bit_identical_to_reference(shape, block):
    """Random values, an all-zero block (absmax 1), the code values
    themselves and the midpoints between neighbouring codes."""
    rng = np.random.default_rng(sum(shape) + block)
    w = (rng.standard_normal(shape) * 2.5).astype(np.float32)
    flat = w.reshape(-1)
    code = np.asarray(RN.NF4_CODE)
    flat[:block] = 0.0
    if flat.size >= 3 * block:
        flat[block:block + 16] = code * 1.5
        flat[2 * block:2 * block + 15] = (code[:-1] + code[1:]) / 2
        flat[2 * block + 15] = 1.0
    ref = RN.nf4_quantize(jnp.asarray(w), block=block)
    got = TN.nf4_quantize(torch.from_numpy(w), block)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.absmax.numpy(), np.asarray(ref.absmax))
    assert (got.shape, got.block) == (tuple(ref.shape), ref.block)
    for dtype, rdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            TN.nf4_dequantize(got, dtype).float().numpy(),
            np.asarray(RN.nf4_dequantize(ref, rdtype), np.float32))


def test_nf4_codebook_is_the_reference_one():
    np.testing.assert_array_equal(np.asarray(TN.NF4_CODE, np.float32),
                                  RN.NF4_CODE)


# ---------------------------------------------------------------------------
# LoRA / QLoRA products
# ---------------------------------------------------------------------------


def test_lora_and_qlora_functions_match_reference():
    rng = np.random.default_rng(0)
    d_in, d_out, r, s = 96, 80, 8, 1.7
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    x = rng.standard_normal((5, d_in)).astype(np.float32)
    a = (rng.standard_normal((d_in, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((r, d_out)) * 0.1).astype(np.float32)
    rp = RL.LoRAParams(a=jnp.asarray(a), b=jnp.asarray(b))
    tp = TL.LoRAParams(_t(a), _t(b))
    _near(TL.lora_forward(_t(x), _t(w), tp, s),
          RL.lora_forward(jnp.asarray(x), jnp.asarray(w), rp, s), where="fwd")
    _near(TL.lora_merge(_t(w), tp, s),
          RL.lora_merge(jnp.asarray(w), rp, s), where="merge")
    r_nf4 = RL.qlora_quantize_base(jnp.asarray(w))
    t_nf4 = TL.qlora_quantize_base(_t(w))
    np.testing.assert_array_equal(t_nf4.codes.numpy(), np.asarray(r_nf4.codes))
    _near(TL.qlora_forward(_t(x), t_nf4, tp, s),
          RL.qlora_forward(jnp.asarray(x), r_nf4, rp, s), where="qlora fwd")
    _near(TL.qlora_merge_fp(t_nf4, tp, s), RL.qlora_merge_fp(r_nf4, rp, s),
          where="qlora merge")
    # merge then PTQ: RTN, then a GPTQ closure on a calibration batch
    calib = rng.standard_normal((256, d_in))
    h = RG.hessian_from_inputs(calib)
    quantizers = (
        (None, None),
        (lambda w_: RG.gptq_quantize(np.asarray(w_), h, 4, 32),
         lambda w_: TG.gptq_quantize(w_, torch.from_numpy(h), 4, 32)))
    for rq, tq in quantizers:
        ref = RL.qlora_merge_ptq(r_nf4, rp, s, 4, 32, quantizer=rq)
        got = TL.qlora_merge_ptq(t_nf4, tp, s, 4, 32, quantizer=tq)
        np.testing.assert_array_equal(got.qweight.numpy(),
                                      np.asarray(ref.qweight))
        _near(got.scale, ref.scale, where="ptq scale")
        _near(got.zero, ref.zero, where="ptq zero")


# ---------------------------------------------------------------------------
# the five schemes
# ---------------------------------------------------------------------------


def _port_linear(rlp, tpol):
    """A reference linear as the port's, through the bridge."""
    return bridge._linear(numpy_tree(rlp), SimpleNamespace(quant=tpol),
                          "blocks/mlp/up", "cpu")


# the cases of tests/test_schemes.py: bits and group only for the
# quantized bases
SCHEME_CASES = [(m, 2, 32) for m in ("fp", "lora", "qlora")] + [
    (m, bits, g) for m in ("qalora", "intq") for bits in (2, 3, 4, 8)
    for g in (32, 64)]


@pytest.mark.parametrize("mode,bits,group", SCHEME_CASES,
                         ids=[f"{m}-{b}-g{g}" for m, b, g in SCHEME_CASES])
def test_scheme_apply_and_merge_match_reference(mode, bits, group):
    d_in, d_out = 128, 48
    kw = dict(mode=mode, bits=bits, group_size=group, rank=4, s=1.7)
    rpol = RS.QuantPolicy(**kw, dtype=jnp.float32)
    tpol = TS.QuantPolicy(**kw, dtype=torch.float32)
    rlp = RS.linear_init(jax.random.PRNGKey(3), d_in, d_out, rpol)
    rlp = RS.LinearParams(data=bump(rlp.data), scheme=rlp.scheme,
                          policy=rlp.policy)
    tlp = _port_linear(rlp, tpol)
    assert tlp.scheme == mode
    x = np.random.default_rng(7).standard_normal((5, d_in)).astype(np.float32)
    _near(TS.linear_apply(tlp, _t(x)), RS.linear_apply(rlp, jnp.asarray(x)),
          where="apply")
    rm, tm = RS.merge_linear(rlp), TS.merge_linear(tlp)
    assert tm.scheme == rm.scheme == ("intq" if mode in ("qalora", "intq")
                                      else "fp")
    _near(TS.dense_view(tm), RS.dense_view(rm), where="merged weight")
    _near(TS.linear_apply(tm, _t(x)), RS.linear_apply(rm, jnp.asarray(x)),
          where="merged apply")
    _near(TS.dense_view(tlp), RS.dense_view(rlp), where="dense view")


@pytest.mark.parametrize("mode", ("fp", "lora", "qlora", "qalora", "intq"))
def test_from_dense_matches_reference(mode):
    """from_dense on one weight: the bases bit for bit (the adapters are
    drawn by each package's own generator; B = 0 on both)."""
    w = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    kw = dict(mode=mode, bits=4, group_size=16, rank=4)
    rlp = RS.from_dense_linear(jax.random.PRNGKey(0), jnp.asarray(w),
                               RS.QuantPolicy(**kw, dtype=jnp.float32))
    tlp = TS.from_dense_linear(torch.Generator().manual_seed(0), _t(w),
                               TS.QuantPolicy(**kw, dtype=torch.float32))
    _same_storage(bridge.linear_numpy(tlp), numpy_tree(rlp), "from_dense")
    assert tlp.scheme == mode and not tlp.exempt


# ---------------------------------------------------------------------------
# convert_tree from a float base
# ---------------------------------------------------------------------------


def _same_storage(got, ref, where):
    """Two numpy layouts equal leaf for leaf, bit for bit, except the
    adapters' A (each package draws its own)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (where, sorted(got), sorted(ref))
        for k in ref:
            if k != "a":
                _same_storage(got[k], ref[k], f"{where}/{k}")
        return
    if isinstance(ref, (str, int, float, tuple)):
        assert got == ref, where
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                  err_msg=where)


def _fp_pair():
    over = dict(n_layers=2, vocab=64)
    rcfg = RC.reduced("llama7b-proxy", **over).scaled(
        quant=RS.QuantPolicy(mode="fp", dtype=jnp.float32))
    tcfg = TC.reduced("llama7b-proxy", **over).scaled(
        quant=TS.QuantPolicy(mode="fp", dtype=torch.float32))
    rparams = RLM(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, tcfg, rparams, bridge.load_numpy_tree(
        numpy_tree(rparams), tcfg, "cpu")


def _targets(name):
    """(reference target, port target) policies."""
    kw = dict(bits=4, group_size=16, rank=4)
    if name == "tree":
        spec = "*=int4,*/attn/wo=intq8,*/mlp/down=qlora,lm_head=int4"
        return (RS.PolicyTree.parse(spec, base=RS.QuantPolicy(
                    **kw, dtype=jnp.float32)),
                TS.PolicyTree.parse(spec, base=TS.QuantPolicy(
                    **kw, dtype=torch.float32)))
    mode, g = {"gptq": ("qalora", 16), "g48": ("qalora", 48)}.get(
        name, (name, 16))
    kw.update(group_size=g)
    return (RS.QuantPolicy(mode=mode, **kw, dtype=jnp.float32),
            TS.QuantPolicy(mode=mode, **kw, dtype=torch.float32))


def _gptq_closures(seed=5, n=256):
    """GPTQ closures keyed by D_in, one calibration batch per D_in."""
    rng = np.random.default_rng(seed)
    hs = {d: RG.hessian_from_inputs(rng.standard_normal((n, d)))
          for d in (64, 96)}
    return (lambda w: RG.gptq_quantize(np.asarray(w), hs[w.shape[0]], 4, 16),
            lambda w: TG.gptq_quantize(w, torch.from_numpy(hs[w.shape[0]]),
                                       4, 16))


CONVERT_TARGETS = ("qalora", "intq", "qlora", "lora", "tree", "gptq", "g48")


@pytest.mark.parametrize("target", CONVERT_TARGETS)
def test_convert_tree_from_fp_matches_reference(target):
    """fp -> each scheme: the converted storage bit for bit (RTN codes,
    NF4, the float weights; GPTQ codes too, its scales and zeros within
    1e-6 in f32), every scheme the reference's, and the converted models'
    logits at init (B = 0) within 1e-5 relative."""
    rcfg, tcfg, rparams, tparams = _fp_pair()
    rpol, tpol = _targets(target)
    rq, tq = _gptq_closures() if target == "gptq" else (None, None)
    rout = RS.convert_tree(rparams, rpol, jax.random.PRNGKey(1),
                           quantizer=rq)
    tout = TS.convert_tree(tparams, tpol, quantizer=tq)
    got, ref = bridge.numpy_tree(tout), numpy_tree(rout)
    if target == "gptq":
        for k in ("scale", "zero"):
            for lin in ("wq", "wo"):
                _near(got["blocks"]["attn"][lin][k],
                      ref["blocks"]["attn"][lin][k], where=k)
                got["blocks"]["attn"][lin].pop(k)
                ref["blocks"]["attn"][lin].pop(k)
            for lin in ("gate", "up", "down"):
                _near(got["blocks"]["mlp"][lin][k],
                      ref["blocks"]["mlp"][lin][k], where=k)
                got["blocks"]["mlp"][lin].pop(k)
                ref["blocks"]["mlp"][lin].pop(k)
    _same_storage(got, ref, target)
    if target == "g48":
        # D_in 64 is not a multiple of 48: those stay fp; down (96) converts
        assert tout.blocks[0]["attn"]["wq"].scheme == "fp"
        assert tout.blocks[0]["mlp"]["down"].scheme == "qalora"
    if target == "tree":
        assert tout.head.scheme == "qalora"
        assert tout.blocks[1]["mlp"]["down"].scheme == "qlora"
        assert TS.quantized_base(tout.blocks[0]["attn"]["wo"]).bits == 8
    toks = np.random.default_rng(2).integers(0, 64, size=(2, 16)) \
        .astype(np.int32)
    r_logits, _ = jax.jit(RLM(rcfg.scaled(quant=rpol)).prefill)(
        rout, {"tokens": jnp.asarray(toks)})
    t_logits, _ = TLM(tcfg.scaled(quant=tpol)).prefill(
        tout, {"tokens": torch.from_numpy(toks)})
    _near(t_logits, r_logits, rel=1e-5, where="logits")


def test_convert_tree_back_to_fp_and_keeps_exempt_and_unchanged():
    """qalora -> fp gives each linear's dense view; an exempt linear and
    one already under the target policy are kept as they are."""
    rcfg, tcfg, rparams, tparams = _fp_pair()
    rpol, tpol = _targets("qalora")
    rq = RS.convert_tree(rparams, rpol, jax.random.PRNGKey(1))
    tq = TS.convert_tree(tparams, tpol)
    fp = TS.QuantPolicy(mode="fp", dtype=torch.float32)
    _same_storage(bridge.numpy_tree(TS.convert_tree(tq, fp)),
                  numpy_tree(RS.convert_tree(
                      rq, RS.QuantPolicy(mode="fp", dtype=jnp.float32))),
                  "to fp")
    again = TS.convert_tree(tq, tpol)
    assert again.blocks[0]["attn"]["wq"] is tq.blocks[0]["attn"]["wq"]
    ex = TS.LinearParams({"w": torch.ones(64, 32)}, exempt=True)
    out = TS.convert_tree(torch.nn.ModuleDict({"router": ex}), tpol)
    assert out["router"] is ex


# ---------------------------------------------------------------------------
# a quantized lm_head
# ---------------------------------------------------------------------------


HEAD_SPEC = "*=int4,lm_head=int4"


@pytest.fixture(scope="module")
def head_pair():
    rcfg = RC.reduced("llama7b-proxy")
    tcfg = TC.reduced("llama7b-proxy")
    rcfg = rcfg.scaled(quant=RS.PolicyTree.parse(HEAD_SPEC, base=rcfg.quant))
    tcfg = tcfg.scaled(quant=TS.PolicyTree.parse(HEAD_SPEC, base=tcfg.quant))
    rlm = RLM(rcfg)
    params = bump(rlm.init(jax.random.PRNGKey(0)))
    # seeded noise on every adapter: with B = 0.01 everywhere (the bump)
    # the head's dA is s pool(x)^T (dY B^T) = 0, since each row of dY sums
    # to 0 over the vocabulary, and both packages would compare round-off
    rng = np.random.default_rng(0)
    params = with_adapters(params, _tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape),
        ref_adapters(params)))
    tparams = bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu")
    return SimpleNamespace(rlm=rlm, tlm=TLM(tcfg), params=params,
                           tparams=tparams, tcfg=tcfg)


def test_lm_init_builds_a_quantized_head(head_pair):
    params = head_pair.tlm.init(torch.Generator().manual_seed(0), "cpu")
    assert params.head.scheme == "qalora"
    assert TS.quantized_base(params.head).d_out == head_pair.tcfg.vocab
    assert "head.ad.a" in TS.trainable_tensors(params)
    cfg = head_pair.tcfg.scaled(quant=TS.PolicyTree.parse(
        "*=int4,lm_head=intq8", base=head_pair.tcfg.quant.default))
    head = TLM(cfg).init(torch.Generator().manual_seed(0), "cpu").head
    assert head.scheme == "intq" and TS.quantized_base(head).bits == 8


@pytest.mark.parametrize("merged", (False, True), ids=("adapters", "merged"))
def test_quantized_head_serves_the_reference_tokens(head_pair, merged):
    rtree, ttree = head_pair.params, head_pair.tparams
    if merged:
        rtree, ttree = RS.merge_tree(rtree), tserve.merge_model(ttree)
        assert ttree.head.scheme == "intq"
    prompts = np.random.default_rng(3).integers(4, 256, size=(2, 6)) \
        .astype(np.int32)
    gen_len, max_len = 6, 12
    rlm = head_pair.rlm
    logits, pre = jax.jit(rlm.prefill)(rtree, {"tokens": jnp.asarray(prompts)})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(2, max_len, dtype=jnp.float32))
    r_gen, _ = rlm.generate(rtree, cache, logits, gen_len)
    t_gen, _ = tserve.generate(head_pair.tlm, ttree, prompts, gen_len,
                               max_len, device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))


def test_quantized_head_loss_and_gradients_match_reference(head_pair):
    """The port's chunked xent runs the head's scheme (the fused product);
    the reference's multiplies by its dense view."""
    toks, labs = _batch()
    r_loss, _ = jax.jit(head_pair.rlm.loss)(head_pair.params,
                                            _rbatch(toks, labs))
    tparams = head_pair.tparams
    trainable = TS.trainable_tensors(tparams)
    t_loss, _ = head_pair.tlm.loss(tparams, _tbatch(toks, labs))
    _close(t_loss.detach().numpy(), np.asarray(r_loss))
    grads = torch.autograd.grad(t_loss, list(trainable.values()))
    got = bridge.adapters_numpy(tparams, dict(zip(trainable, grads)))
    ref = _ref_grads(head_pair.rlm, head_pair.params, _rbatch(toks, labs))
    assert set(got["head"]) == {"a", "b"}
    _close(got, ref)


# ---------------------------------------------------------------------------
# training the baselines
# ---------------------------------------------------------------------------


def _mode_pair(mode, arch="llama7b-proxy"):
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rcfg = rcfg.scaled(quant=dataclasses.replace(rcfg.quant, mode=mode))
    tcfg = tcfg.scaled(quant=dataclasses.replace(tcfg.quant, mode=mode))
    params = bump(RLM(rcfg).init(jax.random.PRNGKey(0)))
    return (RLM(rcfg), TLM(tcfg), params,
            bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu"))


@pytest.mark.parametrize("mode", ("lora", "qlora"))
def test_baseline_train_step_matches_reference(mode):
    """One step of ``--mode lora`` / ``--mode qlora``: loss, grad_norm,
    every A and B gradient, the updated adapters and the AdamW moments
    against ``jax.jit(make_train_fn(...))`` with no mesh."""
    rlm, tlm, params, tparams = _mode_pair(mode)
    assert {lp.scheme for lp in tparams.modules() if TS.is_linear(lp)} \
        == {mode, "fp"}
    toks, labs = _batch(1)
    rb, tb = _rbatch(toks, labs), _tbatch(toks, labs)
    r_tr, r_fr = split_params(params)
    new_tr, new_opt, r_m = jax.jit(ref_train_fn(rlm, RAdamW(lr=LR)))(
        r_tr, r_fr, ref_adamw_init(r_tr), rb)
    trainable = TS.trainable_tensors(tparams)
    assert all(k.endswith((".ad.a", ".ad.b")) for k in trainable)
    loss, _ = tlm.loss(tparams, tb)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    _close(bridge.adapters_numpy(tparams, dict(zip(trainable, grads))),
           _ref_grads(rlm, params, rb))
    frozen = {k: v.clone() for k, v in tparams.named_buffers()}
    opt = adamw_init(trainable)
    t_m = make_train_fn(tlm, AdamWConfig(lr=LR))(tparams, opt, tb)
    for k in ("loss", "grad_norm", "lr"):
        _close(t_m[k].numpy(), np.asarray(r_m[k]), where=k)
    moments = [_moments(tparams, opt, new_opt)]
    _close(bridge.adapters_numpy(tparams), ref_adapters(new_tr),
           allow=_adam_allowance(moments, AdamWConfig(lr=LR)))
    for k, v in tparams.named_buffers():
        assert torch.equal(v, frozen[k]), k


TRAIN_ARGV = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
              "--seq-len", "32", "--global-batch", "4", "--log-every", "1"]


@pytest.mark.parametrize("mode", ("lora", "qlora"))
def test_train_cli_trains_the_baselines(mode, tmp_path):
    res = ttrain.main(TRAIN_ARGV + ["--mode", mode, "--steps", "2",
                                    "--ckpt-dir", str(tmp_path)])
    assert res["end"] == 2 and all(np.isfinite(res["loss"]))
    policy = res["state"].meta["policy"]
    assert policy and all(p[0] == mode for p in policy.values())
    assert all(set(s.values()) == {0} for s in res["launches"])
    # a baseline's checkpoint is refused by serve --adapters
    with pytest.raises(ValueError, match="only qalora"):
        tserve.checkpoint_tenant(res["state"].params, str(tmp_path),
                                 res["state"].meta)


def test_train_cli_refuses_mode_fp(capsys):
    with pytest.raises(SystemExit):
        ttrain.main(TRAIN_ARGV + ["--mode", "fp", "--steps", "1"])
    assert "nothing would train" in capsys.readouterr().err


def test_setup_trains_a_given_converted_model():
    """``setup(args, params=)``: a float base converted to qlora trains in
    place of the seeded model."""
    cfg = TC.reduced("gemma3-1b")
    fp = TLM(cfg.scaled(quant=dataclasses.replace(cfg.quant, mode="fp"))) \
        .init(torch.Generator().manual_seed(0), "cpu")
    args = ttrain.build_parser().parse_args(TRAIN_ARGV + [
        "--mode", "qlora", "--steps", "2"])
    pol = ttrain.build_config(args).quant
    params = TS.convert_tree(fp, pol)
    st = ttrain.setup(args, params=params)
    assert st.params is params
    before = {k: v.clone() for k, v in st.trainable.items()}
    res = ttrain.run(st, args)
    assert all(np.isfinite(res["loss"]))
    assert any(not torch.equal(v, before[k]) for k, v in st.trainable.items())


# ---------------------------------------------------------------------------
# serving the baselines
# ---------------------------------------------------------------------------


def test_bump_and_merge_match_reference_under_qlora_policy():
    """``bump_adapters`` nudges every lora / qlora adapter leaf as the
    reference's serve driver does; the merged (4+16) trees agree and serve
    the reference's greedy tokens."""
    spec = "*=qlora,*/attn/wo=lora,lm_head=qlora"
    rcfg, tcfg = RC.reduced("llama7b-proxy"), TC.reduced("llama7b-proxy")
    rcfg = rcfg.scaled(quant=RS.PolicyTree.parse(spec, base=rcfg.quant))
    tcfg = tcfg.scaled(quant=TS.PolicyTree.parse(spec, base=tcfg.quant))
    rlm = RLM(rcfg)
    params = rlm.init(jax.random.PRNGKey(0))
    tparams = tserve.bump_adapters(
        bridge.load_numpy_tree(numpy_tree(params), tcfg, "cpu"))
    params = bump(params)
    _close(bridge.adapters_numpy(tparams), ref_adapters(params), rel=0.0)
    rmerged, tmerged = RS.merge_tree(params), tserve.merge_model(tparams)
    assert {lp.scheme for lp in tmerged.modules() if TS.is_linear(lp)} \
        == {"fp"}
    got, ref = bridge.numpy_tree(tmerged), numpy_tree(rmerged)
    for lin in ("wq", "wo"):
        _near(got["blocks"]["attn"][lin]["weight"],
              ref["blocks"]["attn"][lin]["weight"], where=lin)
    _near(got["head"]["weight"], ref["head"]["weight"], where="head")
    prompts = np.random.default_rng(3).integers(4, 256, size=(2, 6)) \
        .astype(np.int32)
    logits, pre = jax.jit(rlm.prefill)(rmerged,
                                       {"tokens": jnp.asarray(prompts)})
    cache = rlm.merge_prefill_cache(pre,
                                    rlm.init_cache(2, 12, dtype=jnp.float32))
    r_gen, _ = rlm.generate(rmerged, cache, logits, 6)
    t_gen, _ = tserve.generate(TLM(tcfg), tmerged, prompts, 6, 12,
                               device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))


@pytest.mark.parametrize("policy", ("*=qlora", "*=lora",
                                    "*=int4,lm_head=int4"))
def test_serve_cli_verifies_the_baselines_and_the_quantized_head(policy):
    res = tserve.main(["--arch", "llama7b-proxy", "--reduced", "--device",
                       "cpu", "--requests", "2", "--prompt-len", "8",
                       "--gen-len", "4", "--verify", "--policy", policy])
    assert res["tokens"].shape == (2, 4)
    for check in res["merge_check"].values():
        assert check["rel"] <= res["merge_bound_rel"]
