"""Parity of the port's flash attention (``repro_torch.kernels.ops.flash_mha``
on CPU tensors, which take the plain version of kernel 6) with the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs and the
same block sizes.

Tolerances: f32 rtol = atol = 1e-5 (the same f32 products and softmax,
summed in another order); bf16, per query row, max|diff| <= 2**-6 times
that row's max|o| (two bf16 steps of the row's largest output: both sides
round p and o to bf16 at the same points, so an output may land on a
neighbouring bf16 value).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_mha as ref_flash_mha  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash import flash_mha_cuda  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402

F32_TOL = 1e-5


def _mk(b, sq, h, d, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


def _both(arrays, dtype, **kw):
    """(JAX kernel in interpret mode, port) outputs as f32 numpy."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = ref_flash_mha(*(jnp.asarray(a).astype(jd) for a in arrays),
                        interpret=True, **kw)
    out = ops.flash_mha(*(torch.from_numpy(a).to(td) for a in arrays), **kw)
    assert out.dtype == td and tuple(out.shape) == ref.shape
    return (np.asarray(ref.astype(jnp.float32)),
            out.to(torch.float32).numpy())


def _assert_close(ref, out, dtype):
    assert np.isfinite(out).all()
    if dtype == "bf16":  # per query row (the last axis)
        excess = np.abs(out - ref).max(-1) - 2.0 ** -6 * np.abs(ref).max(-1)
        assert (excess <= 0).all(), excess.max()
    else:
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


# the cases of tests/test_flash_kernel.py, then Sq != Sk under a causal mask
# (top-left aligned: query row i sees keys j <= i whatever Sk is)
CASES = [
    (dict(shape=(2, 64, 2, 16), causal=causal, block_q=32, block_k=32), "f32")
    for causal in (True, False)] + [
    (dict(shape=(1, 128, 4, 32), causal=causal, block_q=32, block_k=32),
     "f32") for causal in (True, False)] + [
    (dict(shape=(1, 64, 2, 16), causal=True, window=16, block_q=16,
          block_k=16), "f32"),
    (dict(shape=(1, 64, 2, 16), causal=True, block_q=32, block_k=32), "bf16"),
    (dict(shape=(1, 32, 2, 16), sk=64, causal=False, block_q=16,
          block_k=16), "f32"),
    (dict(shape=(1, 32, 2, 16), sk=64, causal=True, block_q=16, block_k=16),
     "f32"),
    (dict(shape=(1, 64, 2, 32), sk=32, causal=True, window=8, block_q=16,
          block_k=16), "f32"),
    (dict(shape=(1, 64, 2, 16), sk=32, causal=True, block_q=32, block_k=16),
     "bf16"),
]


@pytest.mark.parametrize("case,dtype", CASES, ids=[
    "mha64-causal", "mha64-full", "mha128-causal", "mha128-full", "window16",
    "bf16", "cross-lengths", "causal-sq32-sk64", "causal-window-sq64-sk32",
    "bf16-causal-sq64-sk32"])
def test_port_matches_pallas_kernel(case, dtype):
    case = dict(case)
    b, sq, h, d = case.pop("shape")
    arrays = _mk(b, sq, h, d, sk=case.pop("sk", None))
    _assert_close(*_both(arrays, dtype, **case), dtype)


def test_causal_is_top_left_aligned():
    """Sq > Sk, causal: query row 0 sees key 0 only, so its output is v[0]
    in both packages."""
    arrays = _mk(1, 64, 2, 16, sk=32, seed=3)
    ref, out = _both(arrays, "f32", causal=True, block_q=32, block_k=32)
    _assert_close(ref, out, "f32")
    np.testing.assert_allclose(out[:, 0], arrays[2][:, 0], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_rows_that_see_no_key_give_the_mean_of_v(dtype):
    """causal=False, window 8, Sq 64 > Sk 16: rows i >= Sk + 8 - 1 see no
    key; every score is -1e30, so p = exp(0) = 1 and the row is the mean
    of V over all keys (not 0, not NaN)."""
    arrays = _mk(1, 64, 2, 16, sk=16, seed=4)
    ref, out = _both(arrays, dtype, causal=False, window=8, block_q=16,
                     block_k=16)
    _assert_close(ref, out, dtype)
    empty = slice(16 + 8 - 1, 64)
    vmean = arrays[2].mean(axis=1, keepdims=True)
    if dtype == "f32":
        np.testing.assert_allclose(out[:, empty], np.broadcast_to(
            vmean, out[:, empty].shape), rtol=F32_TOL, atol=F32_TOL)
    else:
        vm = torch.from_numpy(arrays[2]).to(torch.bfloat16).float() \
            .mean(dim=1, keepdim=True).numpy()
        assert (np.abs(out[:, empty] - vm).max(-1)
                <= 2.0 ** -6 * np.abs(vm).max(-1)).all()


@pytest.mark.parametrize("causal,window", ((True, 0), (False, 0), (True, 16)))
def test_port_matches_port_model_attention(causal, window):
    """The port's flash_mha against the port model's chunked attention (the
    oracle tests/test_flash_kernel.py uses), rtol = atol = 2e-4."""
    q, k, v = (torch.from_numpy(a) for a in _mk(2, 64, 2, 32, seed=5))
    out = ops.flash_mha(q, k, v, causal=causal, window=window, block_q=32,
                        block_k=32)
    ref = flash_attention(q, k, v, causal=causal, window=window or None,
                          chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def test_flash_mha_raises_on_what_it_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 64, 2, 16))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_mha(q, k, v, block_q=48)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_mha(q, k, v, block_k=24)
    with pytest.raises(ValueError, match="MHA"):
        ops.flash_mha(q, k[:, :, :1], v[:, :, :1])
    q24, k24, v24 = (torch.from_numpy(a) for a in _mk(1, 64, 2, 24))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_mha(q24, k24, v24)
    with pytest.raises(TypeError):
        ops.flash_mha(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ops.flash_mha(q, k.to(torch.bfloat16), v)
    fold = q.reshape(2, 64, 16)
    with pytest.raises(ValueError, match="q's d"):
        flash_mha_cuda(fold, fold, fold[..., :8].contiguous())


def test_cpu_calls_do_not_count_as_launches():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 32, 2, 16))
    before = flash_mha_cuda.launches
    ops.flash_mha(q, k, v)
    assert flash_mha_cuda.launches == before
