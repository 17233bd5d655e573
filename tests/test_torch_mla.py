"""Parity of the port's mla_moe family (deepseek-v3-671b: MLA attention
with the absorbed decode over the compressed cache, sigmoid-routed
experts with a shared expert, dense leading layers and the MTP head) with
the JAX package, on the CPU at ``reduced()`` sizes in f32, with no mesh.

The reference tree from ``LM.init`` (adapters nudged by +0.01, as its
serve CLI nudges them) goes to the port through numpy and
``repro_torch.bridge``.  Each MLA function against its reference within
1e-5 of max|ref| (caches equal at the rows written, an idle slot finite);
the absorbed route against the materialised one inside the port; prefill,
static greedy decode (tokens identical, logits within 1e-4), the loss with
its xent, aux and MTP terms and every adapter's gradient (the MTP block's
too) within 1e-5, one train step of the CLI against ``make_train_fn``,
and the merged zeros within 1e-6 (codes and scales bit-identical).  The
reduced MoE routes 4 experts top-2 in f32; in these comparisons no router
tie arises (the routing is held equal where it is compared).
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
from repro.models import attention as RA  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.models.slot_state import mla_cfg as r_mla_cfg  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import merge_params, split_params  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.models.slot_state import (SlotState,  # noqa: E402
                                           mla_cfg as t_mla_cfg)
from _torch_parity import bump, numpy_tree, ref_adapters  # noqa: E402
from test_torch_train import _close  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = 1e-5
PROMPT = 32   # two routing chunks of the reduced moe_chunk 16
GEN_LEN = 6
MLA_LINEARS = ("q_down", "q_up", "kv_down", "kv_up", "wo")


@pytest.fixture(scope="module")
def ref():
    rcfg, tcfg = RC.reduced(ARCH), TC.reduced(ARCH)
    rlm = RLM(rcfg)
    params = bump(jax.jit(rlm.init)(jax.random.PRNGKey(0)))
    merged = RS.merge_tree(params)
    tree = numpy_tree(params)
    return SimpleNamespace(
        rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=TLM(tcfg), params=params,
        merged=merged, tree=tree,
        tparams=bridge.load_numpy_tree(tree, tcfg, "cpu"),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"),
        prompts=np.random.default_rng(0).integers(
            4, rcfg.vocab, size=(2, PROMPT)).astype(np.int32))


def _rel(got, want, tol, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{where}: {err:.3e} of max|ref| > {tol}"


def test_config_matches_reference():
    """Every field of the port's ArchConfig equals the reference's, in the
    full and the reduced config (3 layers, 1 dense, 4 experts top-2, ranks
    32, dims 16), and the policy's numbers."""
    fields = [f.name for f in __import__("dataclasses").fields(TC.ArchConfig)
              if f.name != "quant"]
    for r, t in ((RC.get(ARCH), TC.get(ARCH)),
                 (RC.reduced(ARCH), TC.reduced(ARCH))):
        for name in fields:
            assert getattr(t, name) == getattr(r, name), name
        for name in ("mode", "bits", "group_size", "rank", "s"):
            assert getattr(t.quant, name) == getattr(r.quant, name), name
    assert TC.reduced(ARCH).n_dense_layers == 1


def test_layer_linears_count_mla_blocks():
    """An MLA block's 5 linears plus the dense MLP's 3, or the 256 x 3
    experts' and the shared expert's 3; the reduced model's tree holds
    that many quantized linears a block."""
    lm = TLM(TC.get(ARCH))
    assert [lm.layer_linears(i) for i in range(4)] == [8, 8, 8, 5 + 771]
    assert lm.step_linears() == 3 * 8 + 58 * 776
    tlm = TLM(TC.reduced(ARCH))
    params = tlm.init(torch.Generator().manual_seed(0), "cpu")
    for i, blk in enumerate(params.layer_blocks()):
        quantized = [m for m in blk.modules()
                     if TS.is_linear(m) and m.scheme != "fp"]
        assert len(quantized) == tlm.layer_linears(i) == (8 if i < 1
                                                          else 5 + 15)


# ---------------------------------------------------------------------------
# the MLA functions
# ---------------------------------------------------------------------------


def _attn(ref, layer=0):
    """Dense layer ``layer``'s attention: (reference params, port module)."""
    rp = jax.tree.map(lambda x: x[layer], ref.params["dense_blocks"]["attn"])
    return rp, ref.tparams.dense_blocks[layer]["attn"]


def _x(b, c, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, c, d)).astype(
        np.float32)


def test_mla_apply_matches_reference(ref):
    """``mla_apply`` (the materialised prefill route): output and the
    compressed cache (c, k_rope) within 1e-5 of max|ref|."""
    rp, tp = _attn(ref)
    x = _x(2, 24, ref.rcfg.d_model)
    r_out, (r_c, r_kr) = jax.jit(RA.mla_apply, static_argnums=(2, 3))(
        rp, jnp.asarray(x), r_mla_cfg(ref.rcfg), ref.rcfg.quant)
    with torch.no_grad():
        t_out, (t_c, t_kr) = TA.mla_apply(tp, torch.from_numpy(x),
                                          t_mla_cfg(ref.tcfg))
    for got, want, w in ((t_out, r_out, "out"), (t_c, r_c, "c"),
                         (t_kr, r_kr, "kr")):
        _rel(got.numpy(), want, TOL, w)


_r_chunk = jax.jit(RA.mla_prefill_chunk, static_argnums=(5, 6))


def _stale_cache(b, s, rank, rope, seed=2):
    rng = np.random.default_rng(seed)
    return {"c": rng.normal(size=(b, s, rank)).astype(np.float32),
            "kr": rng.normal(size=(b, s, rope)).astype(np.float32)}


@pytest.mark.parametrize("paged", (False, True), ids=("contiguous", "paged"))
@pytest.mark.parametrize("c,n_new", ((1, (1, 1, 0)), (5, (5, 2, 0))),
                         ids=("decode", "chunk"))
def test_mla_prefill_chunk_matches_reference(ref, paged, c, n_new):
    """``mla_prefill_chunk`` at C = 1 and C = 5 with ragged ``n_new`` (slot
    2 idle, at length 0), over a cache of stale random rows, contiguous
    and in pages of 4: the valid rows' outputs within 1e-5 of max|ref|,
    the idle slot's finite, the cache rows written equal and the others
    untouched.  (Paged: the reference also writes the dropped rows into
    the null page, page 0, which nothing reads; the port leaves it.)"""
    rp, tp = _attn(ref)
    rm, tm = r_mla_cfg(ref.rcfg), t_mla_cfg(ref.tcfg)
    b, s, ps = 3, 16, 4
    cur = np.asarray([3, 9, 0], np.int32)
    n_new = np.asarray(n_new, np.int32)
    x = _x(b, c, ref.rcfg.d_model, seed=3)
    if paged:
        n_pages = b * (s // ps) + 1
        cache = _stale_cache(n_pages, ps, rm.kv_lora_rank, rm.qk_rope_dim)
        pages = (1 + np.arange(b * (s // ps), dtype=np.int32)).reshape(b, -1)
        pages[2, 1:] = 0       # an idle slot's row: mostly the null page
    else:
        cache = _stale_cache(b, s, rm.kv_lora_rank, rm.qk_rope_dim)
        pages = None
    r_out, r_cache = _r_chunk(
        rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(cur), jnp.asarray(n_new), rm, ref.rcfg.quant,
        pages=None if pages is None else jnp.asarray(pages))
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        t_out, t_cache = TA.mla_prefill_chunk(
            tp, torch.from_numpy(x), t_cache, torch.from_numpy(cur),
            torch.from_numpy(n_new), tm,
            pages=None if pages is None else torch.from_numpy(pages))
    r_out, t_out = np.asarray(r_out), t_out.numpy()
    top = np.abs(r_out).max()
    for i in range(b):
        rows = slice(0, max(int(n_new[i]), 1))
        if n_new[i]:
            assert np.abs(t_out[i, rows] - r_out[i, rows]).max() <= TOL * top
    assert np.isfinite(t_out).all()
    for k in ("c", "kr"):
        got, want = t_cache[k].numpy(), np.asarray(r_cache[k])
        if paged:
            got, want, old = got[1:], want[1:], cache[k][1:]
        else:
            old = cache[k]
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())
        changed = np.abs(got - old).max(axis=-1) > 0
        assert changed.sum() == int(n_new.sum()), k


def test_mla_decode_and_init_cache_match_reference(ref):
    """``mla_decode`` (C = 1, every slot active) from ``mla_init_cache``
    after a prefill chunk, with the absorbed weights given: within 1e-5
    of max|ref|, and the fresh caches' shapes and zeros equal."""
    rp, tp = _attn(ref)
    rm, tm = r_mla_cfg(ref.rcfg), t_mla_cfg(ref.tcfg)
    r_cache = RA.mla_init_cache(2, 8, rm, dtype=jnp.float32)
    t_cache = TA.mla_init_cache(2, 8, tm, dtype=torch.float32, device="cpu")
    for k in ("c", "kr"):
        np.testing.assert_array_equal(t_cache[k].numpy(), np.asarray(
            r_cache[k]))
    w_kv = TA.kv_up_split(tp, tm, torch.float32)
    x = _x(2, 4, ref.rcfg.d_model, seed=4)
    cur = np.zeros((2,), np.int32)
    n4 = np.full((2,), 4, np.int32)
    _, r_cache = _r_chunk(rp, jnp.asarray(x), r_cache, jnp.asarray(cur),
                          jnp.asarray(n4), rm, ref.rcfg.quant)
    with torch.no_grad():
        TA.mla_prefill_chunk(tp, torch.from_numpy(x), t_cache,
                             torch.from_numpy(cur), torch.from_numpy(n4), tm)
        x1 = _x(2, 1, ref.rcfg.d_model, seed=5)
        t_out, _ = TA.mla_decode(tp, torch.from_numpy(x1), t_cache,
                                 torch.from_numpy(n4), tm, w_kv=w_kv)
    r_out, _ = jax.jit(RA.mla_decode, static_argnums=(4, 5))(
        rp, jnp.asarray(x1), r_cache, jnp.asarray(n4), rm, ref.rcfg.quant)
    _rel(t_out.numpy(), r_out, TOL, "decode")


def test_absorbed_weights_match_reference(ref):
    """``LM.absorbed_weights``: each layer's (W_uk, W_uv), adapters
    included, within 1e-5 of the reference's stacked pair, on the adapter
    and the merged trees; None for a gqa model."""
    for rp, tp in ((ref.params, ref.tparams), (ref.merged, ref.tmerged)):
        r = ref.rlm.absorbed_weights(rp)
        t = ref.tlm.absorbed_weights(tp)
        for part in ("dense", "moe"):
            for half in (0, 1):
                got = torch.stack([w[half] for w in t[part]]).numpy()
                _rel(got, r[part][half], TOL, f"{part}/{half}")
    assert TLM(TC.reduced("gemma3-1b")).absorbed_weights(None) is None


def test_absorbed_route_equals_materialized_route():
    """Inside the port, on a model of dense layers only (with MoE layers
    the two routes route different row counts, in both packages): the
    chunked ``step_ragged`` over a prompt (the absorbed attention over the
    compressed cache) and ``prefill`` (per-head K/V materialised) give the
    same last-row logits within 1e-5 of max|logit|."""
    cfg = TC.reduced(ARCH, n_layers=2, n_dense_layers=2)
    lm = TLM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        4, cfg.vocab, size=(2, 12)).astype(np.int32))
    want, _ = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    aux = lm.absorbed_weights(params)
    for i in range(0, 12, 4):
        got, cache = lm.step_ragged(params, cache, toks[:, i:i + 4],
                                    torch.full((2,), 4, dtype=torch.int32),
                                    aux=aux)
    _rel(got.numpy(), want.numpy(), TOL, "logits")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_prefill_matches_reference(ref, which):
    """Last-token prefill logits within 1e-5 of ``jax.jit(lm.prefill)`` at
    a prompt of 32 (two routing chunks), the compressed caches of the
    dense and the MoE layers likewise, and the length."""
    rp, tp = ((ref.params, ref.tparams) if which == "adapter"
              else (ref.merged, ref.tmerged))
    r_logits, r_cache = jax.jit(ref.rlm.prefill)(
        rp, {"tokens": jnp.asarray(ref.prompts)})
    t_logits, t_cache = ref.tlm.prefill(
        tp, {"tokens": torch.from_numpy(ref.prompts)})
    _rel(t_logits.numpy(), r_logits, TOL, "logits")
    for part in ("dense", "moe"):
        for leaf in ("c", "kr"):
            _rel(t_cache["layers"][part][leaf].numpy(),
                 r_cache["layers"][part][leaf], TOL, f"{part}/{leaf}")
    np.testing.assert_array_equal(t_cache["len"].numpy(), r_cache["len"])


def _ref_greedy_logits(ref, params, max_len):
    """The reference's prefill, merge into the decode cache and greedy
    decode steps with the absorbed weights, eagerly: (tokens, logits of
    each step)."""
    rlm = ref.rlm
    logits, pre = jax.jit(rlm.prefill)(params,
                                       {"tokens": jnp.asarray(ref.prompts)})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(2, max_len, dtype=jnp.float32))
    aux = rlm.absorbed_weights(params)
    step = jax.jit(lambda c, t: rlm.decode_step(params, c, t, aux=aux))
    toks, steps = [], [np.asarray(logits)]
    for _ in range(GEN_LEN - 1):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = step(cache, tok[:, None])
        steps.append(np.asarray(logits))
    toks.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(toks, 1), steps


@pytest.mark.parametrize("which", ("adapter", "merged"))
def test_static_serve_matches_reference(ref, which):
    """``LM.prefill`` -> ``merge_prefill_cache`` -> ``LM.generate`` (the
    port's generator) against the reference's ``jax.jit(lm.prefill)`` ->
    ``merge_prefill_cache`` -> ``generate``: greedy tokens identical, and
    each step's logits, along the same tokens, within 1e-4 of max|logit|."""
    rp, tp = ((ref.params, ref.tparams) if which == "adapter"
              else (ref.merged, ref.tmerged))
    max_len = PROMPT + GEN_LEN
    toks = jnp.asarray(ref.prompts)
    logits, pre = jax.jit(ref.rlm.prefill)(rp, {"tokens": toks})
    cache = ref.rlm.merge_prefill_cache(
        pre, ref.rlm.init_cache(2, max_len, dtype=jnp.float32))
    r_gen, _ = ref.rlm.generate(rp, cache, logits, GEN_LEN)
    t_gen, _ = tserve.generate(ref.tlm, tp, ref.prompts, GEN_LEN, max_len,
                               device="cpu")
    np.testing.assert_array_equal(t_gen, np.asarray(r_gen))
    want_toks, want = _ref_greedy_logits(ref, rp, max_len)
    np.testing.assert_array_equal(want_toks, t_gen)
    lm = ref.tlm
    lg, pre = lm.prefill(tp, {"tokens": torch.from_numpy(ref.prompts)})
    tcache = lm.merge_prefill_cache(pre, lm.init_cache(
        2, max_len, dtype=torch.float32, device="cpu"))
    aux = lm.absorbed_weights(tp)
    got = [lg.numpy()]
    for i in range(GEN_LEN - 1):
        lg, tcache = lm.decode_step(tp, tcache, torch.from_numpy(
            t_gen[:, i:i + 1]), aux=aux)
        got.append(lg.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        _rel(g, w, 1e-4, f"step {i}")


def _batch(seed=1, b=3, s=PROMPT):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 256, size=(b, s)).astype(np.int32)
    labs = rng.integers(-1, 256, size=(b, s)).astype(np.int32)
    labs[1] = -1
    return toks, labs


@pytest.fixture(scope="module")
def ref_grads(ref):
    """``jax.value_and_grad`` of the reference's ``LM.loss`` on
    :func:`_batch` (remat changes no value): (loss, metrics, adapter
    gradients)."""
    toks, labs = _batch()
    trainable, frozen = split_params(ref.params)

    def loss_fn(tr):
        return ref.rlm.loss(merge_params(tr, frozen),
                            {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labs)})
    (r_loss, r_m), r_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable)
    return r_loss, r_m, ref_adapters(r_grads)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_and_grads_match_reference(ref, ref_grads, remat):
    """loss = xent + 0.3 MTP xent + 0.01 aux: the loss, xent and aux within
    1e-5 of ``jax.value_and_grad`` of the reference's ``LM.loss``, and
    every adapter's gradient (MLA's, the dense MLP's, each expert's, the
    shared expert's and the MTP block's) within 1e-5 of its tensor's
    largest, with and without the port's remat; ``mtp_proj`` is fp,
    exempt, and has no adapter."""
    r_loss, r_m, want = ref_grads
    tcfg = TC.reduced(ARCH, remat=remat)
    tlm, tparams = TLM(tcfg), bridge.load_numpy_tree(ref.tree, tcfg, "cpu")
    toks, labs = _batch()
    tr = TS.trainable_tensors(tparams)
    t_loss, t_m = tlm.loss(tparams, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labs)})
    grads = torch.autograd.grad(t_loss, list(tr.values()))
    _close(t_loss.detach().numpy(), np.asarray(r_loss), where="loss")
    for k in ("xent", "aux"):
        _close(t_m[k].detach().numpy(), np.asarray(r_m[k]), where=k)
    mtp = float(t_loss.detach() - t_m["xent"].detach()
                - 0.01 * t_m["aux"].detach())
    assert mtp > 0.3  # the MTP term is in the loss
    got = bridge.adapters_numpy(tparams, dict(zip(tr, grads)))
    assert set(got) == {"dense_blocks", "moe_blocks", "mtp_block"}
    assert set(got["mtp_block"]["attn"]) == set(MLA_LINEARS)
    assert "shared" in got["moe_blocks"]["moe"]
    _close(got, want)
    assert all(np.abs(g).max() > 0 for g in jax.tree_util.tree_leaves(got))
    assert tparams.mtp_proj.scheme == "fp" and tparams.mtp_proj.exempt


def test_train_cli_step_matches_make_train_fn(ref):
    """One step of ``train --arch deepseek-v3-671b --reduced --device
    cpu`` (the CLI's setup and loop over the reference's tree, on its
    alpaca stream) against ``jax.jit(make_train_fn)`` on the reference
    stream's batch: loss, xent, aux and grad_norm within 1e-5, the first
    moments within 1e-5 and the second within 2e-5 (the square of a
    gradient within 1e-5), and every adapter, the MTP block's too,
    updated within the Adam allowance."""
    from test_torch_train import _adam_allowance
    from repro_torch.optim import AdamWConfig
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
            "--seq-len", str(PROMPT), "--global-batch", "4", "--lr", "2e-4"]
    args = ttrain.build_parser().parse_args(argv)
    tparams = bridge.load_numpy_tree(ref.tree, ref.tcfg, "cpu")
    res = ttrain.run(ttrain.setup(args, params=tparams), args)
    toks, labs = ref_stream("alpaca", vocab=256, seq_len=PROMPT,
                            global_batch=4).next_batch()
    r_tr, r_fr = split_params(ref.params)
    r_opt = ref_adamw_init(r_tr)
    opt_cfg = RAdamW(lr=2e-4, schedule="constant")
    r_tr, r_opt, r_m = jax.jit(ref_train_fn(ref.rlm, opt_cfg))(
        r_tr, r_fr, r_opt, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labs)})
    for k, name in (("loss", "loss"), ("xent", "xent"), ("aux", "aux"),
                    ("grad_norm", "grad_norm")):
        _close(np.asarray(res[name][0]), np.asarray(r_m[k]), where=k)
    st = res["state"]
    port = tuple(bridge.adapters_numpy(st.params, st.opt_state[k])
                 for k in ("mu", "nu"))
    want = tuple(ref_adapters(r_opt[k]) for k in ("mu", "nu"))
    _close(port[0], want[0], where="mu")
    _close(port[1], want[1], rel=2e-5, where="nu")
    moments = [(port, want)]
    allow = _adam_allowance(moments, AdamWConfig(lr=2e-4,
                                                 schedule="constant"))
    _close(bridge.adapters_numpy(st.params), ref_adapters(r_tr), allow=allow)


def test_merged_zeros_match_reference(ref):
    """Every mla linear merged (the MTP block's too): zeros within 1e-6 of
    the reference's largest, codes and scales bit-identical to the
    reference's and to the unmerged base; ``mtp_proj`` and the routers
    stay fp, and a policy conversion never quantizes them."""
    port, want = bridge.numpy_tree(ref.tmerged), numpy_tree(ref.merged)
    base = ref.tree
    n = 0

    def walk(g, w, b, path):
        nonlocal n
        if isinstance(w, dict) and "scheme" in w:
            assert g["scheme"] == w["scheme"], path
            if w["scheme"] == "fp":
                return
            n += 1
            for k in ("qweight", "scale"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=path)
                np.testing.assert_array_equal(g[k], b[k], err_msg=path)
            _rel(g["zero"], w["zero"], 1e-6, path)
            return
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], b[k], f"{path}/{k}")
    walk(port, want, base, "")
    # linear stacks: the dense blocks' 8, the MoE blocks' 5 + the experts'
    # gate, up and down + the shared expert's 3, the MTP block's 8
    assert n == 8 + (5 + 3 + 3) + 8
    assert port["mtp_proj"]["scheme"] == "fp" and port["mtp_proj"]["exempt"]
    conv = TS.convert_tree(ref.tmerged, TS.PolicyTree.parse(
        "*=intq8", ref.tcfg.quant.default))
    assert conv.mtp_proj.scheme == "fp"
    assert conv.moe_blocks[0]["moe"].router.scheme == "fp"
    assert conv.mtp_block["attn"]["kv_up"].scheme == "intq"


def test_bridge_roundtrips_the_mla_tree(ref):
    """``numpy_tree`` of the loaded port tree gives the reference's tree
    back (dense and MoE stacks, the MTP head), and ``load_adapters`` of
    its adapters is exact."""
    back = bridge.numpy_tree(ref.tparams)

    def same(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), (path, sorted(g), sorted(w))
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=path)
        else:
            assert g == w, path
    same(back, ref.tree)
    tparams = bridge.load_numpy_tree(ref.tree, ref.tcfg, "cpu")
    for t in TS.trainable_tensors(tparams).values():
        torch.nn.init.zeros_(t)
    bridge.load_adapters(tparams, ref_adapters(ref.params))
    _close(bridge.adapters_numpy(tparams), ref_adapters(ref.params), rel=0)


def test_slot_state_layout_is_the_references(ref):
    """``SlotState.init`` holds the reference's leaves at its shapes,
    contiguous and paged, and the family speculates (rollback by
    length)."""
    for ps, n_pages in ((0, 0), (4, 9)):
        r = ref.rlm.slot_state(ps, n_pages).init(2, 16, dtype=jnp.float32)
        t = SlotState(ref.tcfg, ps, n_pages).init(2, 16, dtype=torch.float32,
                                                   device="cpu")
        for part in ("dense", "moe"):
            for leaf in ("c", "kr"):
                assert tuple(t["layers"][part][leaf].shape) == \
                    r["layers"][part][leaf].shape
        assert ("pages" in t) == ("pages" in r) == bool(ps)
        if ps:
            assert tuple(t["pages"].shape) == r["pages"].shape
    assert ref.rlm.slot_state().supports_rollback()
    assert SlotState(ref.tcfg).supports_rollback()
