"""Parity of the PyTorch port's attention core, norms, rotary embedding and
QA-LoRA attach with the JAX package, on the CPU, in f32.

Inputs are made with numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import qalora as rq  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as RCM  # noqa: E402
from repro_torch.core import qalora as tq  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TCM  # noqa: E402

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", (
    dict(),                                           # causal, several chunks
    dict(window=4),                                   # sliding window
    dict(window=0),                                   # per-layer "full"
    dict(sq=8, q_offset=8),                           # queries after a prefix
    dict(causal=False, kv_len=(10, 16)),              # ragged keys
), ids=("causal", "window4", "window0", "q_offset", "kv_len"))
def test_flash_attention_matches_reference(case):
    rng = np.random.default_rng(0)
    b, sk, h, kvh, d = 2, 16, 4, 2, 8
    sq = case.get("sq", sk)
    q, k, v = (_randn(rng, b, sq, h, d), _randn(rng, b, sk, kvh, d),
               _randn(rng, b, sk, kvh, d))
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              q_offset=case.get("q_offset", 0), chunk_q=4, chunk_k=8)
    kv_len = case.get("kv_len")
    ref = RA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32))
    out = TA.flash_attention(
        _t(q), _t(k), _t(v), **kw,
        kv_len=None if kv_len is None else torch.tensor(kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("window", (None, 0, 3))
def test_chunk_and_decode_attention_match_reference(window):
    rng = np.random.default_rng(1)
    b, c, s, h, kvh, d = 3, 2, 10, 4, 2, 8
    q = _randn(rng, b, c, h, d)
    kc, vc = _randn(rng, b, s, kvh, d), _randn(rng, b, s, kvh, d)
    qpos = np.array([[0, 1], [4, 5], [8, 9]], np.int32)
    ref = RA.chunk_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(qpos), window=window)
    out = TA.chunk_attention(_t(q), _t(kc), _t(vc), _t(qpos), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)

    cur = np.array([1, 6, 10], np.int32)
    ref = RA.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(cur), window=window)
    out = TA.decode_attention(_t(q[:, :1]), _t(kc), _t(vc), _t(cur),
                              window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("s,c,cur,n_new", [
    (8, 3, [0, 3, 6], [2, 0, 3]),
    # a chunk longer than the cache, and slots that run past its end
    (4, 6, [0, 2, 3], [6, 3, 1]),
    (5, 1, [4, 0, 5], [1, 1, 1])])
def test_insert_tokens_matches_reference(s, c, cur, n_new):
    """Ragged insert: rows past a slot's n_new, and positions past the
    capacity, are dropped on both sides."""
    rng = np.random.default_rng(2)
    b, kvh, d = 3, 2, 4
    cache, new = _randn(rng, b, s, kvh, d), _randn(rng, b, c, kvh, d)
    cur = np.array(cur, np.int32)
    n_new = np.array(n_new, np.int32)
    ref = RA._insert_tokens(jnp.asarray(cache), jnp.asarray(new),
                            jnp.asarray(cur), jnp.asarray(n_new))
    out = TA._insert_tokens(_t(cache).clone(), _t(new), _t(cur), _t(n_new))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_init_cache_layout_matches_reference():
    rcfg = RA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    tcfg = TA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    ref = RA.gqa_init_cache(3, 5, rcfg, dtype=jnp.float32)
    out = TA.gqa_init_cache(3, 5, tcfg, dtype=torch.float32, device="cpu")
    for name in ("k", "v"):
        assert tuple(out[name].shape) == ref[name].shape
        assert not out[name].any()


@pytest.mark.parametrize("act", ("silu", "gelu", "relu"))
def test_norm_rope_act_match_reference(act):
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 5, 3, 8)
    g = _randn(rng, 8)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        TCM.rmsnorm(TCM.RMSNorm(_t(g)), _t(x), 1e-5).numpy(),
        np.asarray(RCM.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x), 1e-5)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        TCM.rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(RCM.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        TCM.act_fn(act)(_t(x)).numpy(),
        np.asarray(RCM.act_fn(act)(jnp.asarray(x))), atol=TOL, rtol=0)


def test_attach_matches_reference():
    """RTN quantization is bit-identical; the adapter starts as the
    identity (B = 0) with A of the reference's shape."""
    w = _randn(np.random.default_rng(4), 64, 24)
    rqt, rp = rq.attach(jax.random.PRNGKey(0), jnp.asarray(w), 4, 16, 8)
    tqt, tp = tq.attach(torch.Generator().manual_seed(0), _t(w), 4, 16, 8)
    for name in ("qweight", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tqt, name).numpy(),
                                      np.asarray(getattr(rqt, name)))
    assert tuple(tp.a.shape) == rp.a.shape and tuple(tp.b.shape) == rp.b.shape
    assert not tp.b.any() and not np.asarray(rp.b).any()
