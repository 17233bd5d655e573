"""Parity of the port's GPTQ (``repro_torch.core.gptq``) with the JAX
package's, on the CPU, in float64, with inputs made by numpy from a seed.

Tolerances: the codes are bit-identical; the scales and zeros within
1e-12 of their largest magnitude (the port's lazy-batch form sums the
later rows' f64 updates in another order than the reference's rank-1
recursion; with one block covering every row it is the reference's
recursion, and equal bit for bit).  The Hessian within 1e-12 of its
largest entry (the two BLAS libraries sum ``X^T X`` in other orders), the
RTN error within 1e-6 relative.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import gptq as RG  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro_torch.core import gptq as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402

REL = 1e-12
# the lazy-batch form at its default block, one group a block, and one
# block over every row (the reference's unblocked recursion)
BLOCKS = {"lazy_128": TG.BLOCK, "lazy_one_group": 1, "unblocked": 1 << 30}


def _calibration(seed, d_in, d_out, n=384, dead=(5,)):
    """A weight, and activations with lognormal per-feature scales (a few
    features far larger than the rest, as in an LLM) and dead features."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)
    x = rng.standard_normal((n, d_in)) * np.exp(rng.standard_normal(d_in))
    x[:, list(dead)] = 0.0
    return w, x


def _assert_same(t, r, rel=REL):
    bits = r.bits
    np.testing.assert_array_equal(TQ.unpack(t.qweight, bits).numpy(),
                                  np.asarray(RQ.unpack(r.qweight, bits)))
    np.testing.assert_array_equal(t.qweight.numpy(), np.asarray(r.qweight))
    for name in ("scale", "zero"):
        got = getattr(t, name).double().numpy()
        ref = np.asarray(getattr(r, name), np.float64)
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), name
    assert (t.bits, t.group_size) == (r.bits, r.group_size)


@pytest.mark.parametrize("block", list(BLOCKS.values()), ids=list(BLOCKS))
@pytest.mark.parametrize("group", (16, 32, 64))
@pytest.mark.parametrize("bits", (2, 3, 4, 8))
def test_gptq_codes_bit_identical_to_reference(bits, group, block):
    w, x = _calibration(bits * 100 + group, 256, 40)
    h = RG.hessian_from_inputs(x)
    ref = RG.gptq_quantize(w, h, bits, group)
    got = TG.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), bits,
                           group, block=block)
    _assert_same(got, ref, rel=0.0 if block >= 256 else REL)


@pytest.mark.parametrize("group", (32, 64))
def test_gptq_at_d_in_512_with_dead_features(group):
    w, x = _calibration(7, 512, 72, n=256, dead=(0, 31, 200, 511))
    ref = RG.gptq_quantize_from_calibration(w, x, 4, group)
    got = TG.gptq_quantize_from_calibration(torch.from_numpy(w),
                                            torch.from_numpy(x), 4, group)
    _assert_same(got, ref)
    # a dead feature's weight is pinned to 0 before it is rounded
    codes = TQ.unpack(got.qweight, 4).double()
    deq = TQ.dequantize(got, torch.float64)
    assert codes.shape == (512, 72)
    assert torch.isfinite(deq).all()


def test_gptq_options_match_reference():
    """``percdamp`` and a bf16 ``scale_dtype``: the codes bit for bit, the
    bf16 scales and zeros within one bf16 step (each side rounds its f64
    value to bf16)."""
    w, x = _calibration(11, 128, 24)
    h = RG.hessian_from_inputs(x)
    ref = RG.gptq_quantize(w, h, 3, 32, percdamp=0.1,
                           scale_dtype=jnp.bfloat16)
    got = TG.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), 3, 32,
                           percdamp=0.1, scale_dtype=torch.bfloat16)
    assert got.scale.dtype == torch.bfloat16
    _assert_same(got, ref, rel=2.0 ** -8)


def test_hessian_matches_reference():
    _, x = _calibration(3, 96, 8)
    got = TG.hessian_from_inputs(torch.from_numpy(x)).numpy()
    ref = RG.hessian_from_inputs(x)
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_gptq_beats_rtn_on_output_mse():
    """The counterpart of tests/test_quant.py's: f32 inputs, bits 4, g 32;
    and at every bit width on the lognormal calibration set."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    x = rng.standard_normal((512, 128)).astype(np.float32)
    cases = [(w, x, 4)] + [(*_calibration(20 + b, 128, 48), b)
                           for b in (2, 3, 4, 8)]
    for w_, x_, bits in cases:
        wt, xt = torch.from_numpy(w_), torch.from_numpy(x_).double()
        qg = TG.gptq_quantize_from_calibration(wt, xt, bits, 32)
        qr = TQ.quantize(wt.float(), bits, 32)
        ref = xt @ wt.double()
        err_g = float(((xt @ TQ.dequantize(qg, torch.float64) - ref) ** 2)
                      .mean())
        err_r = float(((xt @ TQ.dequantize(qr, torch.float64) - ref) ** 2)
                      .mean())
        assert err_g < err_r, bits


def test_gptq_int_codes_valid():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    x = rng.standard_normal((256, 64)).astype(np.float32)
    qt = TG.gptq_quantize_from_calibration(torch.from_numpy(w),
                                           torch.from_numpy(x), 3, 16)
    codes = TQ.unpack(qt.qweight, 3)
    assert int(codes.max()) <= 7 and int(codes.min()) >= 0


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_quantization_error_matches_reference(bits):
    w = np.random.default_rng(bits).standard_normal((256, 64)) \
        .astype(np.float32)
    got = float(TQ.quantization_error(torch.from_numpy(w), bits, 32))
    ref = float(RQ.quantization_error(jnp.asarray(w), bits, 32))
    assert abs(got - ref) <= 1e-6 * ref


def test_block_runner_reuses_its_buffers():
    """Blocks of one shape share one runner (on the card, one captured
    graph); ``release_graphs`` drops them."""
    TG.release_graphs()
    w, x = _calibration(5, 256, 16)
    TG.gptq_quantize_from_calibration(torch.from_numpy(w),
                                      torch.from_numpy(x), 4, 32)
    assert list(TG._RUNNERS) == [("cpu", TG.BLOCK, 16, 32, 15)]
    TG.release_graphs()
    assert not TG._RUNNERS
