"""Parity of the port's Mamba2 and RWKV6 mixers (``repro_torch.models.ssm``)
with the JAX package's (``repro.models.ssm``), function by function, on the
CPU in f32 at the reduced zamba2-7b and rwkv6-7b widths, with no mesh.

Each layer's parameters come from the reference's ``LM.init`` (adapters
nudged by +0.01, as its serve CLI nudges them) through numpy and
``repro_torch.bridge``.  Outputs and states within 1e-5 of max|ref|; the
ragged steps at n_new in {0, 1, C, mixed} over a random nonzero state,
where a masked slot's state must come back bit for bit; the chunk
functions' gradients (the exponents masked and clamped before ``exp``)
finite and within 1e-5 of ``jax.grad``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.models.slot_state import (mamba_cfg as r_mamba_cfg,  # noqa: E402
                                     rwkv_cfg as r_rwkv_cfg)
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.slot_state import (mamba_cfg as t_mamba_cfg,  # noqa: E402
                                           rwkv_cfg as t_rwkv_cfg)
from _torch_parity import bump, numpy_tree  # noqa: E402

TOL = 1e-5
SEQ = 32  # two chunks of the reduced ssm_chunk 16
C = 5     # a ragged chunk
N_NEW = {"idle": (0, 0, 0), "decode": (1, 1, 1), "full": (C, C, C),
         "mixed": (C, 1, 0)}


def _pair(arch):
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    params = bump(jax.jit(RLM(rcfg).init)(jax.random.PRNGKey(0)))
    return SimpleNamespace(rcfg=rcfg, tcfg=tcfg, params=params,
                           tparams=bridge.load_numpy_tree(
                               numpy_tree(params), tcfg, "cpu"))


@pytest.fixture(scope="module")
def mamba():
    p = _pair("zamba2-7b")
    p.rp = jax.tree.map(lambda x: x[0, 0], p.params["mamba_groups"])
    p.tp = p.tparams.mamba_groups[0][0]
    p.rc, p.tc = r_mamba_cfg(p.rcfg), t_mamba_cfg(p.tcfg)
    return p


@pytest.fixture(scope="module")
def rwkv():
    p = _pair("rwkv6-7b")
    p.rp = jax.tree.map(lambda x: x[0], p.params["blocks"]["mix"])
    p.tp = p.tparams.blocks[0]["mix"]
    p.rc, p.tc = r_rwkv_cfg(p.rcfg), t_rwkv_cfg(p.tcfg)
    return p


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{where}: {err:.3e} of max|ref| > {TOL}"


def _tree_rel(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _tree_rel(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _tree_rel(g, w, f"{where}/{i}")
    else:
        _rel(got.detach().numpy() if torch.is_tensor(got) else got,
             np.asarray(want), where)


def test_configs_match_reference(mamba, rwkv):
    """The sub-configs the port derives from its ArchConfig equal the
    reference's, with their derived widths."""
    for p in (mamba, rwkv):
        for name in ("d_model", "head_dim", "chunk", "n_heads"):
            assert getattr(p.tc, name) == getattr(p.rc, name), name
    for name in ("ssm_state", "expand", "conv_width", "d_inner", "conv_dim"):
        assert getattr(mamba.tc, name) == getattr(mamba.rc, name), name
    for name in ("d_ff", "decay_lora"):
        assert getattr(rwkv.tc, name) == getattr(rwkv.rc, name), name


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def test_mamba2_pieces_match_reference(mamba):
    """``_split_in_proj`` and ``_causal_conv`` exactly as the reference
    slices and convolves."""
    c = mamba.tc
    h = _np((2, 7, 2 * c.d_inner + 2 * c.ssm_state + c.n_heads), 1)
    for got, want in zip(TSSM._split_in_proj(_t(h), c),
                         RSSM._split_in_proj(jnp.asarray(h), mamba.rc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xbc = _np((2, 7, c.conv_dim), 2)
    got = TSSM._causal_conv(_t(xbc), mamba.tp.conv_w, mamba.tp.conv_b)
    want = RSSM._causal_conv(jnp.asarray(xbc), mamba.rp["conv_w"],
                             mamba.rp["conv_b"])
    _rel(got.numpy(), want, "conv")


def _ssd_inputs(c, seed=3, q=16, b=2):
    return (_np((b, q, c.n_heads, c.head_dim), seed),
            _np((b, q, c.ssm_state), seed + 1),
            _np((b, q, c.ssm_state), seed + 2),
            -np.abs(_np((b, q, c.n_heads), seed + 3)) * 2)


def test_ssd_chunk_and_its_gradient_match_reference(mamba):
    """One SSD chunk from a nonzero state: output and state within 1e-5,
    and the gradient of a weighted sum of both with respect to every
    input finite and within 1e-5 of ``jax.grad`` (the exponent masked
    before ``exp``: masked after, the backward meets inf * 0)."""
    c = mamba.tc
    xs = _ssd_inputs(c)
    h0 = _np((2, c.n_heads, c.head_dim, c.ssm_state), 7)
    wy, wh = _np((2, 16, c.n_heads, c.head_dim), 8), _np(h0.shape, 9)

    def r_loss(h0_, *xs_):
        h, y = RSSM._ssd_chunk(h0_, xs_, mamba.rc)
        return (h * wh).sum() + (y * wy).sum(), (h, y)
    (_, (r_h, r_y)), r_g = jax.value_and_grad(
        r_loss, argnums=tuple(range(5)), has_aux=True)(
        jnp.asarray(h0), *map(jnp.asarray, xs))
    ts = [_t(a).requires_grad_(True) for a in (h0, *xs)]
    t_h, t_y = TSSM._ssd_chunk(ts[0], tuple(ts[1:]), c)
    ((t_h * _t(wh)).sum() + (t_y * _t(wy)).sum()).backward()
    _rel(t_h.detach().numpy(), r_h, "state")
    _rel(t_y.detach().numpy(), r_y, "y")
    for i, (t, g) in enumerate(zip(ts, r_g)):
        assert torch.isfinite(t.grad).all(), i
        _rel(t.grad.numpy(), g, f"grad {i}")


def test_mamba2_mix_matches_reference(mamba):
    """The prefill path over two chunks: output and the decode state
    (conv window, SSM state) within 1e-5."""
    x = _np((2, SEQ, mamba.tc.d_model), 4)
    r_out, r_st = jax.jit(RSSM.mamba2_mix, static_argnums=(2, 3, 4))(
        mamba.rp, jnp.asarray(x), mamba.rc, mamba.rcfg.quant, True)
    with torch.no_grad():
        t_out, t_st = TSSM.mamba2_mix(mamba.tp, _t(x), mamba.tc,
                                      return_state=True)
    _rel(t_out.numpy(), r_out, "out")
    _tree_rel(t_st, r_st, "state")
    with torch.no_grad():
        np.testing.assert_array_equal(
            TSSM.mamba2_mix(mamba.tp, _t(x), mamba.tc).numpy(),
            t_out.numpy())


def _mamba_state(c, b=3, seed=5):
    return {"conv": _np((b, c.conv_width - 1, c.conv_dim), seed),
            "ssm": _np((b, c.n_heads, c.head_dim, c.ssm_state), seed + 1,
                       0.5)}


_r_mamba_step = jax.jit(RSSM.mamba2_chunk_step, static_argnums=(4, 5))


@pytest.mark.parametrize("case", list(N_NEW))
def test_mamba2_chunk_step_matches_reference(mamba, case):
    """``mamba2_chunk_step`` at C = 5 from a random nonzero state, n_new
    per slot as the case says: the valid rows' outputs and the new state
    within 1e-5 of the reference's, and a slot with n_new = 0 keeps its
    conv window and SSM state bit for bit."""
    c = mamba.tc
    n_new = np.asarray(N_NEW[case], np.int32)
    x = _np((3, C, c.d_model), 6)
    st = _mamba_state(c)
    r_out, r_st = _r_mamba_step(mamba.rp, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in st.items()},
                                jnp.asarray(n_new), mamba.rc,
                                mamba.rcfg.quant)
    with torch.no_grad():
        t_out, t_st = TSSM.mamba2_chunk_step(
            mamba.tp, _t(x), {k: _t(v) for k, v in st.items()}, _t(n_new),
            c)
    _tree_rel(t_st, r_st, "state")
    top = np.abs(np.asarray(r_out)).max()
    for i, n in enumerate(n_new):
        if n:
            assert np.abs(t_out[i, :n].numpy() - np.asarray(r_out)[i, :n]
                          ).max() <= TOL * top
        else:
            for k in st:
                np.testing.assert_array_equal(t_st[k][i].numpy(), st[k][i])


def test_mamba2_decode_and_init_state_match_reference(mamba):
    """``mamba2_decode`` (one token, every slot) from a nonzero state
    within 1e-5, and equal to the ragged step at C = 1; the fresh states'
    shapes and zeros are the reference's."""
    c = mamba.tc
    r0 = RSSM.mamba2_init_state(3, mamba.rc)
    t0 = TSSM.mamba2_init_state(3, c, device="cpu")
    for k in r0:
        np.testing.assert_array_equal(t0[k].numpy(), np.asarray(r0[k]))
    st = _mamba_state(c)
    x = _np((3, 1, c.d_model), 7)
    r_out, r_st = jax.jit(RSSM.mamba2_decode, static_argnums=(3, 4))(
        mamba.rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
        mamba.rc, mamba.rcfg.quant)
    with torch.no_grad():
        t_out, t_st = TSSM.mamba2_decode(
            mamba.tp, _t(x), {k: _t(v) for k, v in st.items()}, c)
        s_out, s_st = TSSM.mamba2_chunk_step(
            mamba.tp, _t(x), {k: _t(v) for k, v in st.items()},
            torch.ones(3, dtype=torch.int32), c)
    _rel(t_out.numpy(), r_out, "out")
    _tree_rel(t_st, r_st, "state")
    _rel(s_out.numpy(), r_out, "ragged C = 1")
    _tree_rel(s_st, r_st, "ragged C = 1 state")


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def test_shift_and_ragged_prev_match_reference(rwkv):
    """The token shift with and without a carry, and the ragged carry (the
    last valid row, or the old carry at n_new = 0), exactly."""
    x, prev = _np((3, C, 8), 1), _np((3, 1, 8), 2)
    np.testing.assert_array_equal(TSSM._shift(_t(x)).numpy(),
                                  np.asarray(RSSM._shift(jnp.asarray(x))))
    np.testing.assert_array_equal(
        TSSM._shift(_t(x), _t(prev)).numpy(),
        np.asarray(RSSM._shift(jnp.asarray(x), jnp.asarray(prev))))
    n_new = np.asarray([C, 0, 2], np.int32)
    np.testing.assert_array_equal(
        TSSM._ragged_prev(_t(prev), _t(x), _t(n_new)).numpy(),
        np.asarray(RSSM._ragged_prev(jnp.asarray(prev), jnp.asarray(x),
                                     jnp.asarray(n_new))))


def test_wkv_chunk_and_its_gradient_match_reference(rwkv):
    """One WKV chunk from a nonzero state, with decays strong enough that
    the chunk's cumulative decay passes e^-30 (the clamped exponentials):
    output and state within 1e-5, and every input's gradient finite and
    within 1e-5 of ``jax.grad``."""
    c = rwkv.tc
    q, h, hd = 16, c.n_heads, c.head_dim
    r, k, v = (_np((2, q, h, hd), s) for s in (1, 2, 3))
    logw = -np.abs(_np((2, q, h, hd), 4)) * 3
    s0 = _np((2, h, hd, hd), 5, 0.5)
    u = np.asarray(rwkv.rp["u"])
    wy, ws = _np((2, q, h, hd), 6), _np(s0.shape, 7)
    assert (np.cumsum(logw, 1).min() < -30)

    def r_loss(s0_, r_, k_, v_, lw_):
        s, y = RSSM._wkv_chunk(s0_, (r_, k_, v_, lw_), rwkv.rc,
                               jnp.asarray(u))
        return (s * ws).sum() + (y * wy).sum(), (s, y)
    (_, (r_s, r_y)), r_g = jax.value_and_grad(
        r_loss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, (s0, r, k, v, logw)))
    ts = [_t(a).requires_grad_(True) for a in (s0, r, k, v, logw)]
    t_s, t_y = TSSM._wkv_chunk(ts[0], tuple(ts[1:]), _t(u))
    ((t_s * _t(ws)).sum() + (t_y * _t(wy)).sum()).backward()
    _rel(t_s.detach().numpy(), r_s, "state")
    _rel(t_y.detach().numpy(), r_y, "y")
    for i, (t, g) in enumerate(zip(ts, r_g)):
        assert torch.isfinite(t.grad).all(), i
        _rel(t.grad.numpy(), g, f"grad {i}")


@pytest.mark.parametrize("carried", (False, True), ids=("fresh", "carried"))
def test_rwkv6_mixes_match_reference(rwkv, carried):
    """The time mix over two chunks (the inter-chunk carry), fresh or from
    a carried (prev x, WKV state), and the channel mix: outputs and the
    carries within 1e-5."""
    c = rwkv.tc
    x = _np((2, SEQ, c.d_model), 8)
    prev = _np((2, 1, c.d_model), 9) if carried else None
    s0 = _np((2, c.n_heads, c.head_dim, c.head_dim), 10, 0.5) \
        if carried else None
    jx = jnp.asarray(x)
    jp = None if prev is None else jnp.asarray(prev)
    r_y, r_st = RSSM.rwkv6_time_mix(rwkv.rp, jx, rwkv.rc, rwkv.rcfg.quant,
                                    prev=jp, state=None if s0 is None
                                    else jnp.asarray(s0))
    r_cy, r_cp = RSSM.rwkv6_channel_mix(rwkv.rp, jx, rwkv.rc,
                                        rwkv.rcfg.quant, prev=jp)
    tp = None if prev is None else _t(prev)
    with torch.no_grad():
        t_y, t_st = TSSM.rwkv6_time_mix(rwkv.tp, _t(x), c, prev=tp,
                                        state=None if s0 is None
                                        else _t(s0))
        t_cy, t_cp = TSSM.rwkv6_channel_mix(rwkv.tp, _t(x), c, prev=tp)
    _rel(t_y.numpy(), r_y, "time mix")
    _tree_rel(t_st, r_st, "time mix state")
    _rel(t_cy.numpy(), r_cy, "channel mix")
    np.testing.assert_array_equal(t_cp.numpy(), np.asarray(r_cp))


def _rwkv_state(c, b=3, seed=11):
    return (_np((b, 1, c.d_model), seed),
            _np((b, c.n_heads, c.head_dim, c.head_dim), seed + 1, 0.5))


@pytest.mark.parametrize("case", list(N_NEW))
def test_rwkv6_ragged_mixes_match_reference(rwkv, case):
    """``rwkv6_time_mix_ragged`` and ``rwkv6_channel_mix_ragged`` at C = 5
    from a random nonzero state, n_new per slot as the case says: valid
    rows' outputs and the new carries and WKV state within 1e-5, and a
    slot with n_new = 0 keeps all three bit for bit."""
    c = rwkv.tc
    n_new = np.asarray(N_NEW[case], np.int32)
    x = _np((3, C, c.d_model), 12)
    prev, s0 = _rwkv_state(c)
    cm_prev = _np((3, 1, c.d_model), 13)
    r_y, (r_tp, r_s) = jax.jit(RSSM.rwkv6_time_mix_ragged,
                               static_argnums=(4, 5))(
        rwkv.rp, jnp.asarray(x), (jnp.asarray(prev), jnp.asarray(s0)),
        jnp.asarray(n_new), rwkv.rc, rwkv.rcfg.quant)
    r_cy, r_cp = RSSM.rwkv6_channel_mix_ragged(
        rwkv.rp, jnp.asarray(x), jnp.asarray(cm_prev), jnp.asarray(n_new),
        rwkv.rc, rwkv.rcfg.quant)
    with torch.no_grad():
        t_y, (t_tp, t_s) = TSSM.rwkv6_time_mix_ragged(
            rwkv.tp, _t(x), (_t(prev), _t(s0)), _t(n_new), c)
        t_cy, t_cp = TSSM.rwkv6_channel_mix_ragged(
            rwkv.tp, _t(x), _t(cm_prev), _t(n_new), c)
    _rel(t_s.numpy(), r_s, "wkv")
    np.testing.assert_array_equal(t_tp.numpy(), np.asarray(r_tp))
    np.testing.assert_array_equal(t_cp.numpy(), np.asarray(r_cp))
    for got, want in ((t_y, r_y), (t_cy, r_cy)):
        top = np.abs(np.asarray(want)).max()
        for i, n in enumerate(n_new):
            if n:
                assert np.abs(got[i, :n].numpy() - np.asarray(want)[i, :n]
                              ).max() <= TOL * top
    for i, n in enumerate(n_new):
        if not n:
            np.testing.assert_array_equal(t_s[i].numpy(), s0[i])
            np.testing.assert_array_equal(t_tp[i].numpy(), prev[i])
            np.testing.assert_array_equal(t_cp[i].numpy(), cm_prev[i])


def test_rwkv6_decode_and_init_state_match_reference(rwkv):
    """``rwkv6_decode_time_mix`` from a nonzero state within 1e-5, and
    equal to the ragged time mix at C = 1; the fresh state's shapes,
    dtypes and zeros are the reference's."""
    c = rwkv.tc
    r0 = RSSM.rwkv6_init_state(3, rwkv.rc)
    t0 = TSSM.rwkv6_init_state(3, c, device="cpu")
    for k in r0:
        np.testing.assert_array_equal(t0[k].numpy(), np.asarray(r0[k]))
    prev, s0 = _rwkv_state(c)
    x = _np((3, 1, c.d_model), 14)
    r_y, (r_p, r_s) = jax.jit(RSSM.rwkv6_decode_time_mix,
                              static_argnums=(3, 4))(
        rwkv.rp, jnp.asarray(x), (jnp.asarray(prev), jnp.asarray(s0)),
        rwkv.rc, rwkv.rcfg.quant)
    with torch.no_grad():
        t_y, (t_p, t_s) = TSSM.rwkv6_decode_time_mix(
            rwkv.tp, _t(x), (_t(prev), _t(s0)), c)
        g_y, (_, g_s) = TSSM.rwkv6_time_mix_ragged(
            rwkv.tp, _t(x), (_t(prev), _t(s0)),
            torch.ones(3, dtype=torch.int32), c)
    _rel(t_y.numpy(), r_y, "y")
    _rel(t_s.numpy(), r_s, "state")
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(r_p))
    _rel(g_y.numpy(), r_y, "ragged C = 1")
    _rel(g_s.numpy(), r_s, "ragged C = 1 state")


def test_init_draws_the_references_shapes(mamba, rwkv):
    """``mamba2_init`` and ``rwkv6_init`` make the reference's fp leaves at
    its shapes and dtypes (and its deterministic ones at its values), and
    the same linears; the fp leaves are buffers, so only the adapters
    train."""
    from repro.models.common import QuantPolicy
    pol = QuantPolicy(bits=4, group_size=16, rank=4, dtype=jnp.float32,
                      scale_dtype=jnp.float32)
    for p, init, rinit, exact in (
            (mamba, TSSM.mamba2_init, RSSM.mamba2_init,
             ("conv_b", "dt_bias", "a_log", "d_skip")),
            (rwkv, TSSM.rwkv6_init, RSSM.rwkv6_init, ("mu", "w0", "cmu"))):
        t = init(torch.Generator().manual_seed(0), p.tc, p.tcfg.quant,
                 device="cpu")
        r = rinit(jax.random.PRNGKey(0), p.rc, pol)
        fp = dict(t.named_buffers(recurse=False))
        linears = {n for n, m in t.named_children() if n not in ("norm",
                                                                 "ln_x")}
        assert set(fp) | linears | {"norm" if "norm" in r else "ln_x"} \
            == set(r)
        for name, b in fp.items():
            assert tuple(b.shape) == r[name].shape, name
            assert str(b.dtype).split(".")[-1] == str(r[name].dtype), name
            if name in exact:
                _rel(b.numpy(), r[name], name)
        assert all(n.endswith((".a", ".b")) for n, _ in t.named_parameters())
