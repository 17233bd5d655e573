"""Gradients of the port's ``qalora`` linear against ``jax.grad`` of the
reference's ``linear_apply``, and the slot rank projection's plain version
against ``pool_g(x[i]) @ A[ids[i]]`` in jnp, on the CPU.

One ``qalora`` linear (64 -> 48, r 8, f32) is built in each package from
the same numpy arrays.  A leading batch of 3 x 5 rows takes the tiled
route (M = 15 > 8) and one of 4 rows the GEMV route, so both branches of
the dispatch are differentiated.  The port's backward is plain PyTorch
(the kernels have no VJP); the reference differentiates its jnp route
(``use_kernel`` False).  Both sum in f32 in other orders: each gradient
within 1e-5 of its own largest magnitude.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import qalora as rq  # noqa: E402
from repro.core import quant as rquant  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import qalora as tq  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.qmatvec import (  # noqa: E402
    qalora_slot_rank_proj_cuda, qalora_slot_rank_proj_plain)

D_IN, D_OUT, RANK, S = 64, 48, 8, 0.7
GRAD_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _arrays(bits, g, lead):
    rng = np.random.default_rng(100 * bits + g + len(lead))
    w = (rng.standard_normal((D_IN, D_OUT)) / np.sqrt(D_IN)).astype(np.float32)
    x = rng.standard_normal(lead + (D_IN,)).astype(np.float32)
    a = (rng.standard_normal((D_IN // g, RANK)) / np.sqrt(D_IN // g)) \
        .astype(np.float32)
    b = (rng.standard_normal((RANK, D_OUT)) * 0.1).astype(np.float32)
    c = rng.standard_normal(lead + (D_OUT,)).astype(np.float32)
    return w, x, a, b, c


def _linears(w, a, b, bits, g):
    """The same qalora linear in both packages: (reference quantized base,
    reference policy, port LinearParams)."""
    rqt = rquant.quantize(jnp.asarray(w), bits, g)
    rpol = RS.QuantPolicy(mode="qalora", bits=bits, group_size=g, rank=RANK,
                          s=S)
    tqt = tquant.quantize(_t(w), bits, g)
    tpol = TS.QuantPolicy(mode="qalora", bits=bits, group_size=g, rank=RANK,
                          s=S)
    tlp = TS.LinearParams({"q": tqt, "ad": tq.QALoRAParams(_t(a), _t(b))},
                          scheme="qalora", policy=tpol)
    return rqt, rpol, tlp


def _assert_grad_close(got, ref, name):
    ref = np.asarray(ref)
    assert got is not None, f"no gradient reached {name}"
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("lead", ((3, 5), (4,)), ids=("tiled", "gemv"))
@pytest.mark.parametrize("g", (16, 32))
@pytest.mark.parametrize("bits", (2, 3, 4))
def test_qalora_grads_match_jax_grad_of_linear_apply(bits, g, lead):
    w, x, a, b, c = _arrays(bits, g, lead)
    rqt, rpol, tlp = _linears(w, a, b, bits, g)

    def loss(x_, a_, b_):
        lp = RS.LinearParams(data={"q": rqt, "ad": rq.QALoRAParams(a_, b_)},
                             scheme="qalora", policy=rpol)
        return jnp.sum(RS.linear_apply(lp, x_) * jnp.asarray(c))
    rdx, rda, rdb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))

    xt = _t(x).requires_grad_(True)
    y = TS.linear_apply(tlp, xt)
    assert y.requires_grad and y.shape == lead + (D_OUT,)
    before = tkernels.launches()
    (y * _t(c)).sum().backward()
    assert tkernels.launches() == before  # CPU: plain versions only
    ad = tlp.ad
    _assert_grad_close(xt.grad, rdx, "x")
    _assert_grad_close(ad.a.grad, rda, "A")
    _assert_grad_close(ad.b.grad, rdb, "B")


@pytest.mark.parametrize("lead", ((3, 5), (4,)), ids=("tiled", "gemv"))
def test_qalora_base_gets_no_gradient(lead):
    """The frozen INT-N base stays out of the graph: even a scale or zero
    that asks for a gradient gets none, and the adapter still does."""
    w, x, a, b, c = _arrays(4, 16, lead)
    _, _, tlp = _linears(w, a, b, 4, 16)
    qt = tlp.q
    qt.scale.requires_grad_(True)
    qt.zero.requires_grad_(True)
    (tops.qalora_matmul(_t(x), qt, tlp.ad, s=S) * _t(c)).sum().backward()
    assert qt.scale.grad is None and qt.zero.grad is None
    assert qt.qweight.grad is None and not qt.qweight.is_floating_point()
    assert tlp.ad.a.grad is not None and tlp.ad.b.grad is not None


@pytest.mark.parametrize("lead", ((3, 5), (4,)), ids=("tiled", "gemv"))
def test_qalora_forward_value_unchanged_by_grad_route(lead):
    """The autograd route gives the forward the plain version gives under
    ``no_grad`` (the serving path), bit for bit."""
    w, x, a, b, _ = _arrays(3, 32, lead)
    _, _, tlp = _linears(w, a, b, 3, 32)
    y = TS.linear_apply(tlp, _t(x).requires_grad_(True))
    with torch.no_grad():
        y0 = TS.linear_apply(tlp, _t(x))
    assert not y0.requires_grad
    assert torch.equal(y.detach(), y0)


@pytest.mark.parametrize("m", (1, 4, 8))
@pytest.mark.parametrize("g", (16, 32))
def test_slot_rank_proj_plain_matches_jnp(m, g):
    """Row i's ``pool_g(x[i]) @ A[ids[i]]`` over a 4-adapter bank whose row
    0 is the null adapter: rows of id 0 give exact zeros.  f32: the same
    sums in another order, within 2e-5."""
    rng = np.random.default_rng(10 * m + g)
    n_groups = D_IN // g
    x = rng.standard_normal((m, D_IN)).astype(np.float32)
    bank = (rng.standard_normal((4, n_groups, RANK)) / np.sqrt(n_groups)) \
        .astype(np.float32)
    bank[0] = 0
    ids = np.array([(3 * i + 1) % 4 for i in range(m)], dtype=np.int32)
    if m > 1:
        ids[1] = 0
    pooled = rq.group_pool(jnp.asarray(x), g)
    ref = np.stack([np.asarray(pooled[i] @ jnp.asarray(bank[ids[i]]))
                    for i in range(m)])
    got = qalora_slot_rank_proj_plain(_t(x), _t(bank), _t(ids), group_size=g)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    assert (got.numpy()[ids == 0] == 0).all()
    before = tkernels.launches()
    wrapped = qalora_slot_rank_proj_cuda(_t(x), _t(bank), _t(ids),
                                         group_size=g)
    assert tkernels.launches() == before  # CPU: the plain version
    assert torch.equal(wrapped, got)
