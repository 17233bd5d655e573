"""The port's six CUDA kernels against their plain PyTorch versions, on the
card, at small shapes: the dequant-matmul kernels at all four bit widths,
flash attention in bf16 and f32 at every head dim it takes.

Needs an NVIDIA Hopper card and ``nvcc``; skips cleanly without them.  It
imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: both sides round w to bf16 at the same point and multiply
exactly in f32; they differ only in the order of the f32 sums (and, with
an adapter, in where a pooled sum rounds to bf16), so each output may land
on a neighbouring bf16 value: two bf16 steps of the largest output,
2**-6 * max|y|.  Flash attention: bf16 within 2**-6 of each query row's
max|o| (p and o round to bf16 at the same points, p relative to another
running max); f32 within rtol = atol = 2e-4 (the bound of
tests/test_flash_kernel.py).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.kernels.flash import flash_mha_cuda, flash_mha_plain
from repro_torch.kernels.qalora_fused import (qalora_matmul_cuda,
                                              qalora_matmul_plain,
                                              qalora_rank_proj_cuda,
                                              qalora_rank_proj_plain)
from repro_torch.kernels.qmatmul import block_k, qmatmul_cuda, qmatmul_plain
from repro_torch.kernels.qmatvec import (qalora_matvec_cuda,
                                         qalora_matvec_plain,
                                         qalora_slot_matvec_cuda,
                                         qalora_slot_matvec_plain,
                                         qalora_slot_rank_proj_cuda,
                                         qalora_slot_rank_proj_plain,
                                         qmatvec_cuda, qmatvec_plain)

pytestmark = pytest.mark.cuda

BITS = (2, 3, 4, 8)
PAIRS = {
    "qmatvec": (qmatvec_cuda, qmatvec_plain, False, 4),
    "qmatmul": (qmatmul_cuda, qmatmul_plain, False, 100),
    "qalora_matvec": (qalora_matvec_cuda, qalora_matvec_plain, True, 8),
    "qalora_matmul": (qalora_matmul_cuda, qalora_matmul_plain, True, 40),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except build.KernelBuildError as e:
        pytest.skip(str(e))
    build.build_all()
    return torch.device("cuda")


def _inputs(dev, bits, m, k=256, n=96, g=32, rank=8, scale_dtype=torch.bfloat16,
            seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed * 97 + bits * 7 + m)
    w = torch.randn((k, n), generator=gen, device=dev) / np.sqrt(k)
    qt = quant.quantize(w, bits, g, scale_dtype=scale_dtype)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    a = (torch.randn((k // g, rank), generator=gen, device=dev) / np.sqrt(k // g)
         + 0.01).to(torch.bfloat16)
    b = (torch.randn((rank, n), generator=gen, device=dev) * 0.05
         + 0.01).to(torch.bfloat16)
    return x, qt, a, b


def _run(name, x, qt, a, b, s=0.7):
    kern, plain, adapter, _ = PAIRS[name]
    args = (x, qt.qweight, qt.scale, qt.zero)
    kw = dict(bits=qt.bits, group_size=qt.group_size)
    if adapter:
        args += (a, b)
        kw["s"] = s
    before = kern.launches
    y = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    return y, plain(*args, **kw)


def _assert_close(y, ref):
    assert y.dtype == ref.dtype == torch.bfloat16 and y.shape == ref.shape
    y, ref = y.float(), ref.float()
    assert torch.isfinite(y).all()
    tol = 2.0 ** -6 * ref.abs().max().item()
    err = (y - ref).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_kernel_matches_plain(card, name, bits):
    m = PAIRS[name][3]
    _assert_close(*_run(name, *_inputs(card, bits, m)))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_kernel_f32_scales(card, name):
    m = PAIRS[name][3]
    x, qt, a, b = _inputs(card, 4, m, scale_dtype=torch.float32, seed=1)
    _assert_close(*_run(name, x, qt, a, b))


@pytest.mark.parametrize("m", (1, 3, 8))
@pytest.mark.parametrize("name", ("qmatvec", "qalora_matvec"))
def test_gemv_splits_k_across_a_cluster(card, name, m):
    """A long K over few columns: the GEMV kernels split K across the
    blocks of a cluster and add the blocks' partials in rank order, so
    repeated calls give identical bits."""
    x, qt, a, b = _inputs(card, 4, m, k=4096, n=64, seed=3)
    y, ref = _run(name, x, qt, a, b)
    _assert_close(y, ref)
    assert torch.equal(y, _run(name, x, qt, a, b)[0])


@pytest.mark.parametrize("name", ("qmatmul", "qalora_matmul"))
def test_tiled_kernels_take_unaligned_x(card, name):
    """x at an odd element offset: the tiled kernels load it one element at
    a time instead of 16 bytes at a time."""
    x, qt, a, b = _inputs(card, 4, 70, seed=2)
    xu = _unaligned(x)
    y, ref = _run(name, xu, qt, a, b)
    _assert_close(y, ref)
    y_aligned, _ = _run(name, x, qt, a, b)
    assert torch.equal(y, y_aligned)


# the tiled kernels' edges: M around the 64- and 128-row tiles, N of 96
# (16-aligned), 100 (not 16-aligned: narrower copies) and 200 (ragged last
# tile), every group size block_k takes, with K = 2 * block_k(g) + g (a
# last K step of one group)
EDGE_M = (9, 65, 127, 129, 257)
EDGE_N = (96, 100, 200)
EDGE_G = (16, 24, 32, 64, 128)


def _unaligned(x):
    """x's values at an odd element offset (not 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 and xu.is_contiguous()
    return xu


@pytest.mark.parametrize("scale_dtype", ("bf16", "f32"))
@pytest.mark.parametrize("g", EDGE_G)
@pytest.mark.parametrize("bits", BITS)
def test_tiled_kernels_at_their_edges(card, bits, g, scale_dtype):
    sd = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    k = 2 * block_k(g) + g
    for m in EDGE_M:
        for n in EDGE_N:
            x, qt, a, b = _inputs(card, bits, m, k=k, n=n, g=g, rank=16,
                                  scale_dtype=sd, seed=n)
            for name in ("qmatmul", "qalora_matmul"):
                y, ref = _run(name, x, qt, a, b)
                try:
                    _assert_close(y, ref)
                except AssertionError as e:
                    raise AssertionError(f"{name} M={m} N={n} K={k}") from e


@pytest.mark.parametrize("rank", (8, 64))
@pytest.mark.parametrize("g", (16, 24, 32, 128))
@pytest.mark.parametrize("m", (9, 130))
def test_rank_projection_kernel_matches_plain(card, m, g, rank):
    """Kernel 3's first launch alone, t = bf16(pool_g(x) @ A): within two
    bf16 steps of max|t| (a pooled sum, taken in another order, may round
    to a neighbouring bf16 value), and the same bits from an unaligned x
    (one element at a time instead of 16 bytes)."""
    x, _, a, _ = _inputs(card, 4, m, k=4 * block_k(g), g=g, rank=rank)
    before = qalora_rank_proj_cuda.launches
    t = qalora_rank_proj_cuda(x, a, group_size=g)
    torch.cuda.synchronize()
    assert qalora_rank_proj_cuda.launches == before + 1
    _assert_close(t, qalora_rank_proj_plain(x, a, group_size=g))
    assert torch.equal(qalora_rank_proj_cuda(_unaligned(x), a, group_size=g),
                       t)


def test_wrappers_refuse_what_kernels_do_not_take(card):
    x, qt, a, b = _inputs(card, 4, 4)
    with pytest.raises(TypeError):
        qmatvec_cuda(x.float(), qt.qweight, qt.scale, qt.zero, bits=4,
                     group_size=32)
    with pytest.raises(ValueError):
        qmatvec_cuda(torch.cat([x, x, x]), qt.qweight, qt.scale, qt.zero,
                     bits=4, group_size=32)  # M = 12 > GEMV_MAX_M
    with pytest.raises(ValueError):
        qmatmul_cuda(x, qt.qweight.T, qt.scale, qt.zero, bits=4,
                     group_size=32)
    for fn in (qalora_matvec_cuda, qalora_matmul_cuda):  # A/B bf16 only
        with pytest.raises(TypeError):
            fn(x, qt.qweight, qt.scale, qt.zero, a.float(), b.float(), s=1.0,
               bits=4, group_size=32)


def test_reset_and_read_launch_counts(card):
    kernels.reset_launches()
    _run("qmatvec", *_inputs(card, 4, 2))
    counts = kernels.launches()
    assert counts["qmatvec"] == 1 and sum(counts.values()) == 1
    kernels.reset_launches()
    _run("qalora_matmul", *_inputs(card, 4, 40))
    counts = kernels.launches()
    assert counts["qalora_matmul"] == counts["qalora_rank_proj"] == 1
    assert sum(counts.values()) == 2


def _bank(dev, a, b, n_bank=4, seed=0):
    """A bank of ``n_bank`` adapters shaped like (a, b); row 0 is the null
    adapter."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ab = (torch.randn((n_bank,) + a.shape, generator=gen, device=dev)
          * a.float().std() + 0.01).to(torch.bfloat16)
    bb = (torch.randn((n_bank,) + b.shape, generator=gen, device=dev)
          * 0.05 + 0.01).to(torch.bfloat16)
    ab[0] = 0
    bb[0] = 0
    return ab, bb


@pytest.mark.parametrize("m", (1, 4, 8))
@pytest.mark.parametrize("bits", BITS)
def test_slot_kernel_matches_plain(card, bits, m):
    x, qt, a, b = _inputs(card, bits, m, seed=4)
    ab, bb = _bank(card, a, b)
    ids = torch.tensor([(i * 3 + 1) % 4 for i in range(m)], dtype=torch.int32,
                       device=card)
    args = (x, qt.qweight, qt.scale, qt.zero, ab, bb, ids)
    kw = dict(s=0.7, bits=bits, group_size=qt.group_size)
    before = qalora_slot_matvec_cuda.launches
    y = qalora_slot_matvec_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert qalora_slot_matvec_cuda.launches == before + 1
    _assert_close(y, qalora_slot_matvec_plain(*args, **kw))
    # each row equals the single-adapter kernel on its own bank row
    for i in range(m):
        one = qalora_matvec_cuda(x[i:i + 1], qt.qweight, qt.scale, qt.zero,
                                 ab[ids[i]], bb[ids[i]], **kw)
        _assert_close(y[i:i + 1], one)


@pytest.mark.parametrize("m", (1, 4, 8))
def test_slot_kernel_null_ids_equal_qmatvec_bit_for_bit(card, m):
    x, qt, a, b = _inputs(card, 4, m, k=4096, n=96, seed=5)
    ab, bb = _bank(card, a, b)
    zeros = torch.zeros((m,), dtype=torch.int32, device=card)
    y = qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, ab, bb,
                                zeros, s=2.0, bits=4, group_size=32)
    base = qmatvec_cuda(x, qt.qweight, qt.scale, qt.zero, bits=4,
                        group_size=32)
    assert torch.equal(y, base)


def test_slot_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, qt, a, b = _inputs(card, 4, 4)
    ab, bb = _bank(card, a, b)
    ids = torch.zeros((4,), dtype=torch.int32, device=card)
    kw = dict(s=1.0, bits=4, group_size=32)
    with pytest.raises(ValueError, match="ids"):
        qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, ab, bb,
                                ids.long(), **kw)
    with pytest.raises(ValueError, match="ids"):
        qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, ab, bb,
                                ids[:3], **kw)
    with pytest.raises(TypeError):
        qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, ab.float(),
                                bb.float(), ids, **kw)
    with pytest.raises(ValueError, match="banks"):
        qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, a, b, ids,
                                **kw)


@pytest.mark.parametrize("m", (1, 4, 8))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", ("qalora_matvec", "qalora_slot_matvec"))
def test_hoisted_adapter_gemv_matches_plain(card, name, bits, m):
    """Kernels 4 and 5 with the rank projection hoisted out of the GEMV: one
    host call launches the projection (counted apart) and the GEMV, which
    reads t in its epilogue; a K long enough for a cluster split."""
    x, qt, a, b = _inputs(card, bits, m, k=2048, n=160, seed=6)
    kw = dict(s=0.7, bits=bits, group_size=qt.group_size)
    if name == "qalora_matvec":
        kern, plain, proj, extra = (qalora_matvec_cuda, qalora_matvec_plain,
                                    qalora_rank_proj_cuda, (a, b))
    else:
        ab, bb = _bank(card, a, b)
        ids = torch.tensor([(i * 3 + 1) % 4 for i in range(m)],
                           dtype=torch.int32, device=card)
        kern, plain, proj, extra = (qalora_slot_matvec_cuda,
                                    qalora_slot_matvec_plain,
                                    qalora_slot_rank_proj_cuda, (ab, bb, ids))
    args = (x, qt.qweight, qt.scale, qt.zero) + extra
    before = (kern.launches, proj.launches)
    y = kern(*args, **kw)
    torch.cuda.synchronize()
    assert (kern.launches, proj.launches) == (before[0] + 1, before[1] + 1)
    _assert_close(y, plain(*args, **kw))
    assert torch.equal(y, kern(*args, **kw))  # fixed summation order


@pytest.mark.parametrize("m", (1, 4, 8))
@pytest.mark.parametrize("name", ("qmatvec", "qalora_matvec",
                                  "qalora_slot_matvec"))
def test_gemv_edges_unaligned_n_and_x(card, name, m):
    """N = 100 (not 8-aligned: byte loads for the codes, element loads for
    scale and zero, B read from global memory in the epilogue) and x at an
    odd element offset (element loads for x): within tolerance, and the
    unaligned x gives the aligned x's bits."""
    x, qt, a, b = _inputs(card, 4, m, k=1024, n=100, rank=16, seed=9)
    kw = dict(bits=4, group_size=qt.group_size)
    if name == "qmatvec":
        kern, plain, extra = qmatvec_cuda, qmatvec_plain, ()
    elif name == "qalora_matvec":
        kern, plain, extra = qalora_matvec_cuda, qalora_matvec_plain, (a, b)
        kw["s"] = 0.7
    else:
        ab, bb = _bank(card, a, b)
        ids = torch.tensor([(i * 3 + 1) % 4 for i in range(m)],
                           dtype=torch.int32, device=card)
        kern, plain, extra = (qalora_slot_matvec_cuda,
                              qalora_slot_matvec_plain, (ab, bb, ids))
        kw["s"] = 0.7
    w = (qt.qweight, qt.scale, qt.zero)
    y = kern(x, *w, *extra, **kw)
    torch.cuda.synchronize()
    _assert_close(y, plain(x, *w, *extra, **kw))
    assert torch.equal(kern(_unaligned(x), *w, *extra, **kw), y)


@pytest.mark.parametrize("m", (1, 4, 8))
def test_slot_rank_proj_kernel_matches_plain(card, m):
    """Kernel 5's first launch alone: row i's t from bank row ids[i] within
    two bf16 steps of max|t|, rows of id 0 exact zeros."""
    x, _, a, b = _inputs(card, 4, m, k=1024, rank=64, seed=7)
    ab, _ = _bank(card, a, b)
    ids = torch.tensor([(i * 3 + 1) % 4 for i in range(m)], dtype=torch.int32,
                       device=card)
    if m > 1:
        ids[1] = 0
    before = qalora_slot_rank_proj_cuda.launches
    t = qalora_slot_rank_proj_cuda(x, ab, ids, group_size=32)
    torch.cuda.synchronize()
    assert qalora_slot_rank_proj_cuda.launches == before + 1
    _assert_close(t, qalora_slot_rank_proj_plain(x, ab, ids, group_size=32))
    assert (t[ids == 0] == 0).all()


@pytest.mark.parametrize("rank", (8, 64))
@pytest.mark.parametrize("g", (16, 32))
@pytest.mark.parametrize("m", (1, 4, 8))
def test_gemv_rank_proj_entry_matches_plain(card, m, g, rank):
    """Kernel 4's first launch alone (one row of x a block, as kernel 4's C
    entry launches it), through its C entry: within two bf16 steps of
    max|t|, the same bits from an unaligned x."""
    from repro_torch.kernels import build
    x, _, a, _ = _inputs(card, 4, m, k=1024, g=g, rank=rank, seed=8)

    def proj(x_):
        t_ = torch.empty((m, rank), dtype=torch.bfloat16, device=card)
        build.check(build.library("qmatvec").qalora_gemv_rank_proj_bf16(
            x_.data_ptr(), a.data_ptr(), t_.data_ptr(), m, 1024, g, rank,
            build.current_stream()), "qalora_gemv_rank_proj_bf16")
        return t_
    t = proj(x)
    torch.cuda.synchronize()
    _assert_close(t, qalora_rank_proj_plain(x, a, group_size=g))
    assert torch.equal(proj(_unaligned(x)), t)


def test_slot_kernel_traps_on_an_id_outside_the_bank(card, tmp_path):
    """A bad id never serves another tenant's weights: the kernel traps.
    A trap ends the CUDA context, so it runs in a process of its own."""
    import subprocess
    import sys
    from pathlib import Path
    script = tmp_path / "bad_id.py"
    script.write_text(
        "import torch\n"
        "from repro_torch.core import quant\n"
        "from repro_torch.kernels.qmatvec import qalora_slot_matvec_cuda\n"
        "d = 'cuda'\n"
        "qt = quant.quantize(torch.randn(256, 96, device=d), 4, 32,\n"
        "                    scale_dtype=torch.bfloat16)\n"
        "x = torch.randn(2, 256, device=d).to(torch.bfloat16)\n"
        "ab = torch.zeros(3, 8, 8, device=d, dtype=torch.bfloat16)\n"
        "bb = torch.zeros(3, 8, 96, device=d, dtype=torch.bfloat16)\n"
        "ids = torch.tensor([1, 3], dtype=torch.int32, device=d)\n"
        "qalora_slot_matvec_cuda(x, qt.qweight, qt.scale, qt.zero, ab, bb,\n"
        "                        ids, s=1.0, bits=4, group_size=32)\n"
        "torch.cuda.synchronize()\n"
        "print('NO TRAP')\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(__import__("os").environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "NO TRAP" not in res.stdout, res.stdout


def test_gemv_launch_counts(card):
    kernels.reset_launches()
    _run("qalora_matvec", *_inputs(card, 4, 4))
    counts = kernels.launches()
    assert counts["qalora_matvec"] == counts["qalora_rank_proj"] == 1
    assert sum(counts.values()) == 2


@pytest.mark.parametrize("m", (4, 40), ids=("gemv", "tiled"))
def test_qalora_autograd_on_the_card(card, m):
    """A bf16 step through the kernels on the card: the gradients for x, A
    and B are within 2**-6 of each one's largest magnitude of the f32
    plain route on the CPU, on the same values."""
    from repro_torch.core.qalora import QALoRAParams
    x, qt, a, b = _inputs(card, 4, m, seed=8)
    c = torch.randn((m, qt.d_out), device=card).to(torch.bfloat16)

    def grads(dev, dtype):
        q = quant.QuantizedLinear(qt.qweight.to(dev), qt.scale.to(dev),
                                  qt.zero.to(dev), qt.bits, qt.group_size)
        p = QALoRAParams(a.to(dev, dtype).clone(), b.to(dev, dtype).clone())
        xd = x.to(dev, dtype).clone().requires_grad_(True)
        (ops.qalora_matmul(xd, q, p, s=0.7) * c.to(dev, dtype)).sum() \
            .backward()
        return [t.grad.float().cpu() for t in (xd, p.a, p.b)]
    kernels.reset_launches()
    got = grads(card, torch.bfloat16)
    counts = kernels.launches()
    assert counts["qalora_matvec" if m <= 8 else "qalora_matmul"] == 1
    for name, gk, gr in zip("xAB", got, grads("cpu", torch.float32)):
        tol = 2.0 ** -6 * gr.abs().max().item()
        assert (gk - gr).abs().max().item() <= tol, name


def test_qalora_autograd_under_checkpoint_recomputes_through_kernel_3(card):
    """``ops.qalora_matmul`` under ``torch.utils.checkpoint`` (the model's
    remat) gives the same output and gradients as without it, bit for bit
    (the same kernel launches on the same values), and launches kernel 3
    and its projection twice (forward, then again in the backward) where
    the plain call launches them once."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.core.qalora import QALoRAParams
    x, qt, a, b = _inputs(card, 4, 40, seed=9)
    c = torch.randn((40, qt.d_out), device=card).to(torch.bfloat16)

    def run(remat):
        p = QALoRAParams(a.clone(), b.clone())
        xd = x.clone().requires_grad_(True)

        def f(x_):
            return ops.qalora_matmul(x_, qt, p, s=0.7) * c
        kernels.reset_launches()
        y = checkpoint(f, xd, use_reentrant=False) if remat else f(xd)
        y.sum().backward()
        torch.cuda.synchronize()
        return [y.detach(), xd.grad, p.a.grad, p.b.grad], kernels.launches()
    plain, n_plain = run(False)
    remat, n_remat = run(True)
    assert n_plain["qalora_matmul"] == n_plain["qalora_rank_proj"] == 1
    assert n_remat["qalora_matmul"] == n_remat["qalora_rank_proj"] == 2
    for name, got, want in zip(("y", "x", "A", "B"), remat, plain):
        assert torch.equal(got, want), name


# flash attention: (Sq, Sk, causal, window) cases, run at every head dim;
# Sq != Sk both ways, ragged lengths, and rows that see no key (Sq past
# Sk + window - 1, causal or not: the mean of V over all keys)
FLASH_CASES = [(128, 128, c, w) for c in (True, False) for w in (0, 16)] + [
    (64, 128, False, 0), (128, 64, True, 0), (64, 16, False, 8),
    (100, 100, True, 16), (72, 40, False, 0), (96, 40, True, 16)]


def _flash_inputs(dev, b, sq, sk, h, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((b, s, h, d), generator=gen, device=dev)
                 .to(dtype) for s in (sq, sk, sk))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"sq{c[0]}-sk{c[1]}-{'causal' if c[2] else 'full'}"
                              f"-w{c[3]}" for c in FLASH_CASES])
@pytest.mark.parametrize("d", (16, 32, 64, 128, 256))
@pytest.mark.parametrize("dtype", ("bf16", "f32"))
def test_flash_kernel_matches_plain(card, dtype, d, case):
    sq, sk, causal, window = case
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = _flash_inputs(card, 1, sq, sk, 2, d, tdt, seed=d + sq)
    before = flash_mha_cuda.launches
    y = ops.flash_mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_mha_cuda.launches == before + 1
    assert flash_mha_cuda.last_design == _flash_design(tdt, d)

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(2, t.shape[1], d).contiguous()
    ref = flash_mha_plain(fold(q), fold(k), fold(v), causal=causal,
                          window=window, block_q=sq, block_k=sk)
    y = fold(y).float()
    ref = ref.float()
    assert y.shape == ref.shape and torch.isfinite(y).all()
    if dtype == "bf16":  # per query row, 2**-6 of the row's own max|o|
        _assert_rows_close(y, ref)
    else:
        torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def _flash_design(dtype, d):
    """The design flash_mha_fwd launches: the wgmma kernel for bf16 at the
    served head dims, the mma.sync kernel otherwise."""
    return "wgmma_tma" if dtype == torch.bfloat16 and d >= 64 else "mma_sync"


def _assert_rows_close(y, ref):
    """bf16: every query row within 2**-6 of that row's own max|ref|."""
    y, ref = y.float(), ref.float()
    assert y.shape == ref.shape and torch.isfinite(y).all()
    tol = 2.0 ** -6 * ref.abs().amax(-1)
    assert ((y - ref).abs().amax(-1) <= tol).all(), \
        ((y - ref).abs().amax(-1) / tol).max().item()


def _flash_bf16_vs_plain(dev, b, sq, sk, h, d, causal, window, seed):
    """(kernel output, plain version's), both [B*H, Sq, d], bf16."""
    q, k, v = (t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], d)
               .contiguous() for t in _flash_inputs(dev, b, sq, sk, h, d,
                                                    torch.bfloat16, seed))
    y = flash_mha_cuda(q, k, v, causal=causal, window=window, block_q=sq,
                       block_k=sk)
    torch.cuda.synchronize()
    assert flash_mha_cuda.last_design == "wgmma_tma"
    return y, flash_mha_plain(q, k, v, causal=causal, window=window,
                              block_q=sq, block_k=sk)


# the wgmma design's tile edges (128 query rows a block, 128 keys a ring
# stage; 64 at d = 256): lengths around them, Sq != Sk both ways, windows
# of 1, 63, 64 and 65 crossing a key tile's edge, and rows that see no key
# (non-causal window 1, Sq 257 > Sk 64: rows i >= 64)
FLASH_EDGE_CASES = [(s, s, True, 0) for s in (127, 128, 129, 255, 257)] + [
    (129, 257, True, 0), (257, 129, False, 0), (255, 128, True, 0),
    (257, 257, True, 1), (257, 257, True, 63), (257, 257, True, 64),
    (257, 257, True, 65), (255, 129, False, 64), (257, 64, False, 1)]


@pytest.mark.parametrize("case", FLASH_EDGE_CASES,
                         ids=[f"sq{c[0]}-sk{c[1]}-{'causal' if c[2] else 'full'}"
                              f"-w{c[3]}" for c in FLASH_EDGE_CASES])
@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_wgmma_design_at_its_tile_edges(card, d, case):
    sq, sk, causal, window = case
    _assert_rows_close(*_flash_bf16_vs_plain(card, 1, sq, sk, 2, d, causal,
                                             window, seed=sq + sk + d))


@pytest.mark.parametrize("window", (0, 512))
@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_wgmma_deep_rows(card, d, window):
    """S 4096, causal: a deep row averages thousands of keys, far below the
    tensor's max, so a wrong key tile shows in the row-wise bound."""
    _assert_rows_close(*_flash_bf16_vs_plain(card, 1, 4096, 4096, 2, d, True,
                                             window, seed=d + window))


@pytest.mark.parametrize("d", (64, 128, 256))
def test_flash_wgmma_is_bit_identical_run_to_run(card, d):
    """No race in the ring: two calls on the same input agree bit for
    bit."""
    q, k, v = (t.permute(0, 2, 1, 3).reshape(8, 1024, d).contiguous()
               for t in _flash_inputs(card, 2, 1024, 1024, 4, d,
                                      torch.bfloat16, seed=d))
    ys = [flash_mha_cuda(q, k, v, causal=True, window=w)
          for w in (0, 0, 300, 300)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[2], ys[3])


@pytest.mark.parametrize("d", (16, 32, 64, 128, 256))
@pytest.mark.parametrize("dtype", ("bf16", "f32"))
def test_flash_reports_the_design_it_launched(card, dtype, d):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (t.reshape(2, 64, d) for t in _flash_inputs(
        card, 1, 64, 64, 2, d, tdt))
    flash_mha_cuda.last_design = None
    flash_mha_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_mha_cuda.last_design == _flash_design(tdt, d)


def test_flash_rows_that_see_no_key_give_the_mean_of_v(card):
    q, k, v = _flash_inputs(card, 1, 64, 16, 2, 64, torch.float32, seed=9)
    y = ops.flash_mha(q, k, v, causal=False, window=8)
    vmean = v.mean(dim=1, keepdim=True).expand(1, 64 - 23, 2, 64)
    torch.testing.assert_close(y[:, 23:], vmean, rtol=2e-4, atol=2e-4)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _flash_inputs(card, 2, 64, 64, 1, 64, torch.bfloat16)
    q, k, v = (t.reshape(2, 64, 64) for t in (q, k, v))
    before = flash_mha_cuda.launches
    with pytest.raises(TypeError):
        flash_mha_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_mha_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_mha_cuda(q.transpose(0, 1), k.transpose(0, 1),
                       v.transpose(0, 1))
    with pytest.raises(ValueError, match="on cuda"):
        flash_mha_cuda(q, k.cpu(), v)
    assert flash_mha_cuda.launches == before


# ---------------------------------------------------------------------------
# the baselines' path: the lm_head's shape, and GPTQ on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_kernels_at_the_lm_head_shape(card, name):
    """A quantized lm_head of llama7b-proxy: K 4096, N 32000, int4 g32,
    rank 64 (kernels 3 and 4 unmerged, 1 and 2 merged)."""
    m = PAIRS[name][3]
    x, qt, a, b = _inputs(card, 4, m, k=4096, n=32000, g=32, rank=64, seed=2)
    _assert_close(*_run(name, x, qt, a, b))


@pytest.mark.parametrize("bits,g", ((4, 32), (3, 64), (2, 16), (8, 32)))
def test_gptq_on_the_card_matches_the_cpu(card, bits, g):
    """The same GPTQ call on the card (its blocks replayed from one
    captured graph) and on the CPU, both in f64: at least 99.99 % of the
    codes identical and none more than one level apart (the two sum the
    f64 products in other orders), the scales within 1e-9 relative."""
    from repro_torch.core import gptq
    rng = np.random.default_rng(bits * 10 + g)
    d_in, d_out = 512, 96
    w = torch.from_numpy(rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
    x = torch.from_numpy(rng.standard_normal((384, d_in))
                         * np.exp(rng.standard_normal(d_in)))
    x[:, 7] = 0  # a dead feature
    h = gptq.hessian_from_inputs(x)
    try:
        for _ in range(2):  # a second call replays the captured blocks only
            on_card = gptq.gptq_quantize(w.to(card), h.to(card), bits, g)
            on_cpu = gptq.gptq_quantize(w, h, bits, g)
            a_ = quant.unpack(on_card.qweight, bits).cpu().to(torch.int32)
            b_ = quant.unpack(on_cpu.qweight, bits).to(torch.int32)
            assert (a_ == b_).double().mean().item() >= 0.9999
            assert int((a_ - b_).abs().max()) <= 1
            rel = ((on_card.scale.cpu() - on_cpu.scale).abs().max()
                   / on_cpu.scale.abs().max()).item()
            assert rel <= 1e-9, rel
    finally:
        gptq.release_graphs()
