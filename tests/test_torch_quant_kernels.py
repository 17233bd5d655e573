"""Parity of the PyTorch port's quantization, QA-LoRA adapter, merge and
kernel plain versions with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
reference's Pallas kernels run in interpret mode, as its own tests run
them on the CPU.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import qalora as rq  # noqa: E402
from repro.core import quant as rquant  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import qalora as tq  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import schemes as tschemes  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.qalora_fused import (  # noqa: E402
    qalora_matmul_cuda, qalora_rank_proj_cuda, qalora_rank_proj_plain)
from repro_torch.kernels.qmatmul import block_k, qmatmul_cuda  # noqa: E402
from repro_torch.kernels.qmatvec import (qalora_matvec_cuda,  # noqa: E402
                                         qmatvec_cuda)

BITS = (2, 3, 4, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _weights(seed, k=128, n=48):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:32, 3] = 0.25  # a degenerate (all-equal) group: scale must be 1
    return w


def _quant_pair(w, bits, g):
    rqt = rquant.quantize(jnp.asarray(w), bits, g)
    tqt = tquant.quantize(_t(w), bits, g)
    return rqt, tqt


def _first_code_mismatch(w, rqt, tqt, bits, g):
    """Name the first differing code and the quotient it was rounded from."""
    rc = np.asarray(rquant.unpack(rqt.qweight, bits))
    tc = tquant.unpack(tqt.qweight, bits).numpy()
    idx = tuple(int(i) for i in np.argwhere(rc != tc)[0])
    r, c = idx
    sc = np.asarray(rqt.scale)[r // g, c]
    zr = np.asarray(rqt.zero)[r // g, c]
    quot = (np.float32(w[r, c]) - zr) / sc
    return (f"code at (row {r}, col {c}): jax {rc[idx]} vs torch {tc[idx]}; "
            f"(w - zero) / scale = {quot!r} (a rounding tie is at .5)")


@pytest.mark.parametrize("g", (16, 32))
@pytest.mark.parametrize("bits", BITS)
def test_quantize_bit_identical(bits, g):
    w = _weights(bits * 100 + g)
    rqt, tqt = _quant_pair(w, bits, g)
    if not np.array_equal(np.asarray(rqt.qweight), tqt.qweight.numpy()):
        pytest.fail(_first_code_mismatch(w, rqt, tqt, bits, g))
    assert tqt.qweight.dtype == torch.uint8
    assert tqt.qweight.shape == tuple(rqt.qweight.shape)
    for name in ("scale", "zero"):
        a, b = np.asarray(getattr(rqt, name)), getattr(tqt, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.asarray(rqt.scale)[0, 3] == 1.0 == tqt.scale[0, 3].item()
    np.testing.assert_array_equal(
        np.asarray(rquant.dequantize(rqt)), tquant.dequantize(tqt).numpy())


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(64, 24)).astype(np.uint8)
    rp = np.asarray(rquant.pack(jnp.asarray(codes), bits))
    tp = tquant.pack(_t(codes), bits)
    np.testing.assert_array_equal(rp, tp.numpy())
    assert tp.shape == (tquant.packed_rows(64, bits), 24)
    np.testing.assert_array_equal(tquant.unpack(tp, bits).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(rquant.unpack(jnp.asarray(rp), bits)),
        tquant.unpack(tp, bits).numpy())


def _adapter(seed, n_groups, rank, n, bump=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_groups, rank)) / np.sqrt(n_groups)
    b = rng.standard_normal((rank, n)) * 0.05 + bump
    return a.astype(np.float32), b.astype(np.float32)


def test_qalora_pool_delta_forward_agree():
    g, rank = 16, 4
    w = _weights(7)
    x = np.random.default_rng(8).standard_normal((3, 5, 128)).astype(np.float32)
    a, b = _adapter(9, 128 // g, rank, 48)
    rqt, tqt = _quant_pair(w, 4, g)
    rp, tp = rq.QALoRAParams(jnp.asarray(a), jnp.asarray(b)), tq.QALoRAParams(_t(a), _t(b))
    with torch.no_grad():
        np.testing.assert_allclose(
            tq.group_pool(_t(x), g).numpy(),
            np.asarray(rq.group_pool(jnp.asarray(x), g)), atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            tq.adapter_delta(_t(x), tp, 0.7, g).numpy(),
            np.asarray(rq.adapter_delta(jnp.asarray(x), rp, 0.7, g)),
            atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            tq.qalora_forward(_t(x), tqt, tp, 2.0).numpy(),
            np.asarray(rq.qalora_forward(jnp.asarray(x), rqt, rp, 2.0)),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("bits", BITS)
def test_merge_codes_scales_identical_zeros_close(bits):
    g, rank, s = 32, 8, 2.0
    w = _weights(bits)
    a, b = _adapter(bits + 1, 128 // g, rank, 48, bump=0.01)
    rqt, tqt = _quant_pair(w, bits, g)
    rm = rq.merge(rqt, rq.QALoRAParams(jnp.asarray(a), jnp.asarray(b)), s)
    tm = tq.merge(tqt, tq.QALoRAParams(_t(a), _t(b)), s)
    assert tm.qweight is tqt.qweight and tm.scale is tqt.scale
    np.testing.assert_array_equal(np.asarray(rm.qweight), tm.qweight.numpy())
    np.testing.assert_array_equal(np.asarray(rm.scale), tm.scale.numpy())
    # A @ B is summed in each library's own order: not bit-identical
    np.testing.assert_allclose(tm.zero.numpy(), np.asarray(rm.zero),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", BITS)
def test_merged_forward_equals_adapter_forward(bits):
    """The paper's exact-merge claim, through the port's scheme API."""
    g = 16
    pol = tschemes.QuantPolicy(mode="qalora", bits=bits, group_size=g, rank=4,
                               s=2.0)
    gen = torch.Generator().manual_seed(bits)
    lp = tschemes.linear_init(gen, 128, 40, pol, device="cpu")
    with torch.no_grad():
        ad = tschemes.adapter_params(lp)
        ad.a.add_(0.01)
        ad.b.add_(0.05)
        merged = tschemes.merge_linear(lp)
        assert merged.scheme == "intq"
        assert tschemes.quantized_base(merged).qweight is \
            tschemes.quantized_base(lp).qweight
        x = torch.from_numpy(np.random.default_rng(bits).standard_normal(
            (6, 128)).astype(np.float32))
        y_ad = tschemes.linear_apply(lp, x)
        y_m = tschemes.linear_apply(merged, x)
    np.testing.assert_allclose(y_m.numpy(), y_ad.numpy(), atol=1e-4, rtol=0)


def _kernel_inputs(bits, m, g=32, k=128, n=64, rank=8):
    rng = np.random.default_rng(1000 * bits + m)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a, b = _adapter(bits * 7 + m, k // g, rank, n, bump=0.01)
    rqt, tqt = _quant_pair(w, bits, g)
    return x, rqt, tqt, (a, b)


@pytest.mark.parametrize("m", (1, 8, 40))
@pytest.mark.parametrize("bits", BITS)
def test_qmatmul_plain_matches_pallas_interpret(bits, m):
    x, rqt, tqt, _ = _kernel_inputs(bits, m)
    y_pallas = np.asarray(rops.qmatmul(jnp.asarray(x), rqt, interpret=True))
    y_ref = np.asarray(rref.qmatmul_ref(jnp.asarray(x), rqt))
    before = tkernels.launches()
    y = tops.qmatmul(_t(x), tqt).numpy()
    assert tkernels.launches() == before  # CPU calls take the plain version
    np.testing.assert_allclose(y, y_pallas, atol=2e-5, rtol=0)
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tref.qmatmul_ref(_t(x), tqt).numpy(), y_ref,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("m", (1, 8, 40))
@pytest.mark.parametrize("bits", BITS)
def test_qalora_matmul_plain_matches_pallas_interpret(bits, m):
    x, rqt, tqt, (a, b) = _kernel_inputs(bits, m)
    rp = rq.QALoRAParams(jnp.asarray(a), jnp.asarray(b))
    tp = tq.QALoRAParams(_t(a), _t(b))
    y_pallas = np.asarray(rops.qalora_matmul(jnp.asarray(x), rqt, rp, s=0.7,
                                             interpret=True))
    y_ref = np.asarray(rref.qalora_matmul_ref(jnp.asarray(x), rqt, rp, 0.7))
    with torch.no_grad():
        y = tops.qalora_matmul(_t(x), tqt, tp, s=0.7).numpy()
        y_tref = tref.qalora_matmul_ref(_t(x), tqt, tp, 0.7).numpy()
    np.testing.assert_allclose(y, y_pallas, atol=2e-5, rtol=0)
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(y_tref, y_ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("g", (16, 24, 32))
@pytest.mark.parametrize("m", (1, 9, 40))
def test_rank_proj_plain_matches_group_pool_at_a(m, g):
    """Kernel 3's rank projection, plain version, against the reference's
    ``group_pool(x) @ A``.  f32: the same sums in another order, within
    2e-5.  bf16 (the kernel's cast points: pooled x, A and t round to
    bf16): against the reference on the same bf16-rounded x and A, each
    entry within 2**-7 of ``|pool(x)| @ |A|`` (one rounding of each
    pooled value and one of t, each at most 2**-9 relative)."""
    rng = np.random.default_rng(100 * m + g)
    k, rank = 4 * g, 8
    x = rng.standard_normal((m, k)).astype(np.float32)
    a = (rng.standard_normal((k // g, rank)) / np.sqrt(k // g)).astype(
        np.float32)
    ref = np.asarray(rq.group_pool(jnp.asarray(x), g) @ jnp.asarray(a))
    before = tkernels.launches()
    got = qalora_rank_proj_cuda(_t(x), _t(a), group_size=g)
    assert tkernels.launches() == before  # CPU calls take the plain version
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)

    xb, ab = _t(x).to(torch.bfloat16), _t(a).to(torch.bfloat16)
    tb = qalora_rank_proj_plain(xb, ab, group_size=g)
    assert tb.dtype == torch.bfloat16 and tb.shape == (m, rank)
    xr, ar = xb.float().numpy(), ab.float().numpy()
    pooled = np.asarray(rq.group_pool(jnp.asarray(xr), g))
    ref_b = pooled @ ar
    bound = 2.0 ** -7 * (np.abs(pooled) @ np.abs(ar))
    assert (np.abs(tb.float().numpy() - ref_b) <= bound + 1e-6).all()


@pytest.mark.parametrize("m,gemv", ((1, True), (8, True), (9, False),
                                    (40, False)))
def test_dispatch_routes_by_m(monkeypatch, m, gemv):
    """M <= GEMV_MAX_M takes the GEMV kernels, larger M the tiled ones, for
    any leading dims."""
    calls = []
    for name in ("qmatvec_cuda", "qmatmul_cuda", "qalora_matvec_cuda",
                 "qalora_matmul_cuda"):
        real = getattr(tops, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(tops, name, spy)
    x, _, tqt, (a, b) = _kernel_inputs(4, m)
    x3 = _t(x).reshape(1, m, 128)
    with torch.no_grad():
        assert tops.qmatmul(x3, tqt).shape == (1, m, 64)
        assert tops.qalora_matmul(x3, tqt, tq.QALoRAParams(_t(a), _t(b)),
                                  s=1.0).shape == (1, m, 64)
    expect = (["qmatvec_cuda", "qalora_matvec_cuda"] if gemv
              else ["qmatmul_cuda", "qalora_matmul_cuda"])
    assert calls == expect


def test_wrappers_never_compute_plain_off_cpu():
    """Off the CPU a wrapper computes no plain values: a ``meta`` tensor
    (a dry run) takes the plain version's shape logic and gets ``meta``
    outputs of the kernel's shape, with no launch; a CUDA tensor launches
    the kernel or raises (tests/test_torch_kernels_cuda.py)."""
    from repro_torch import kernels
    x, _, tqt, (a, b) = _kernel_inputs(4, 4)
    meta = dict(device="meta")
    xm = torch.empty((4, 128), dtype=torch.bfloat16, **meta)
    q = [t.to("meta") for t in (tqt.qweight, tqt.scale, tqt.zero)]
    am, bm = _t(a).to("meta"), _t(b).to("meta")
    kernels.reset_launches()
    for fn in (qmatvec_cuda, qmatmul_cuda):
        y = fn(xm, *q, bits=4, group_size=32)
        assert y.device.type == "meta" and tuple(y.shape) == (4, 64)
    for fn in (qalora_matvec_cuda, qalora_matmul_cuda):
        y = fn(xm, *q, am, bm, s=1.0, bits=4, group_size=32)
        assert y.device.type == "meta" and tuple(y.shape) == (4, 64)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


@pytest.mark.parametrize("g,bk", ((16, 64), (32, 64), (64, 64), (128, 128),
                                  (24, 96)))
def test_tiled_block_k_is_legal(g, bk):
    assert block_k(g) == bk
    assert bk % g == 0 and bk % 16 == 0 and 64 <= bk <= 128
