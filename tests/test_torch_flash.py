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

import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import flash_mha as ref_flash_mha  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash import flash_mha_cuda  # noqa: E402
from repro_torch.launch import flash_variants  # noqa: E402
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
# the CUDA kernel's tile edges (128 query rows a block, 128 or 64 keys a
# stage): ragged lengths around them in one Pallas block each, Sq != Sk,
# windows of 1, 63, 64 and 65 crossing a key tile's edge, and rows that see
# no key (non-causal window 1 with Sq > Sk: rows i >= Sk see none)
EDGE_CASES = [
    (dict(shape=(1, 127, 2, 16), sk=129, causal=True, block_q=127,
          block_k=129), "bf16"),
    (dict(shape=(1, 129, 2, 16), sk=127, causal=False, block_q=129,
          block_k=127), "f32"),
    (dict(shape=(1, 255, 1, 32), sk=257, causal=True, window=63,
          block_q=255, block_k=257), "bf16"),
    (dict(shape=(1, 257, 1, 16), sk=255, causal=True, window=65,
          block_q=257, block_k=255), "f32"),
    (dict(shape=(1, 256, 1, 16), causal=True, window=1), "f32"),
    (dict(shape=(1, 256, 1, 16), causal=True, window=64), "bf16"),
    (dict(shape=(1, 257, 1, 16), sk=64, causal=False, window=1, block_q=257,
          block_k=64), "f32"),
    (dict(shape=(1, 257, 1, 16), sk=64, causal=False, window=1, block_q=257,
          block_k=64), "bf16"),
]


@pytest.mark.parametrize("case,dtype", CASES + EDGE_CASES, ids=[
    "mha64-causal", "mha64-full", "mha128-causal", "mha128-full", "window16",
    "bf16", "cross-lengths", "causal-sq32-sk64", "causal-window-sq64-sk32",
    "bf16-causal-sq64-sk32", "bf16-causal-sq127-sk129", "full-sq129-sk127",
    "bf16-window63-sq255-sk257", "window65-sq257-sk255", "window1-s256",
    "bf16-window64-s256", "no-key-rows-sq257-sk64",
    "bf16-no-key-rows-sq257-sk64"])
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


def _chip_smoke():
    """chip_smoke.py as a module (its top level defines constants and
    functions only)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row", flash_variants.ROWS,
                         ids=[r[0] for r in flash_variants.ROWS])
def test_flash_variants_rows_and_bounds_match_chip_smoke(row):
    """launch/flash_variants.py times the rows chip_smoke.py does, with the
    same visible pairs, bound and row-wise tolerance."""
    cs = _chip_smoke()
    assert flash_variants.ROWS == cs.FLASH_ROWS
    assert flash_variants.ROW_TOL == cs.FLASH_BF16_ROW_TOL
    _, b, s, h, _, d, w = row
    assert flash_variants.visible_pairs(s, s, True, w) == \
        cs._visible_pairs(s, s, True, w)
    assert flash_variants.bound(b * h, s, s, d, True, w) == \
        cs._flash_bound(b * h, s, s, d, True, w)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (100, 100, True, 16), (72, 40, False, 0), (96, 40, True, 16),
    (64, 16, False, 8), (40, 72, False, 5)])
def test_flash_variants_visible_pairs_off_the_rows(sq, sk, causal, window):
    cs = _chip_smoke()
    assert flash_variants.visible_pairs(sq, sk, causal, window) == \
        cs._visible_pairs(sq, sk, causal, window)


def test_flash_variants_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        flash_variants.main([])


@pytest.mark.parametrize("name", sorted(flash_variants.VARIANTS))
def test_flash_variants_patch_the_committed_source(name):
    """Every variant's replacement finds its text exactly once, and the
    variant differs from the committed sources (but for ``committed``)."""
    repl = flash_variants.VARIANTS[name][0]
    for key, val in repl.items():
        file, pairs = (key, val) if isinstance(val, dict) else \
            ("flash.cu", {key: val})
        src = (build.CSRC / file).read_text()
        for old in pairs:
            assert src.count(old) == 1, (name, file, old)
    patched = flash_variants.patched_sources(name)
    changed = [f for f, text in patched.items()
               if text != (build.CSRC / f).read_text()]
    assert sorted(changed) == ([] if name == "committed" else sorted(
        {k if isinstance(v, dict) else "flash.cu" for k, v in repl.items()}))


def test_flash_variants_summary_and_ptxas_report():
    record = {"rows": {"r": {"bound_ms": 0.1}}, "times": [
        {"row": "r", "round": 0, "ms": {"committed": 0.3, "sdpa_default": 0.2,
                                        "sdpa_cudnn_attention": 0.25,
                                        "sdpa_flash_attention": 0.5}},
        {"row": "r", "round": 1, "ms": {"committed": 0.35,
                                        "sdpa_default": 0.21,
                                        "sdpa_cudnn_attention": 0.24,
                                        "sdpa_flash_attention": 0.45}}]}
    (out,) = flash_variants.summarize(record)
    assert out["fastest_sdpa"] == "sdpa_cudnn_attention"
    assert out["library_ms"] == 0.24
    assert out["ms"]["committed"] == (0.3, 0.35)
    assert out["over_library"]["committed"] == pytest.approx(0.3 / 0.24)
    assert out["over_bound"]["committed"] == pytest.approx(3.0)
    log = ("ptxas info    : Compiling entry function '_ZN3fooEv' for 'sm_90a'\n"
           "ptxas info    : Compiling entry function '_Z11flash_wgmmaILi128E' "
           "for 'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\nptxas info    : Used 168 registers\n")
    assert flash_variants.flash_ptxas(log) == {"_Z11flash_wgmmaILi128E": {
        "registers": 168, "stack": 0, "spill_stores": 8, "spill_loads": 4}}


def test_flash_variants_sass_counts(monkeypatch):
    """--sass reads each wgmma instantiation's highest register, wgmma,
    waits on wgmma and local loads and stores from cuobjdump's listing."""
    listing = """
\t\tFunction : _ZN4anon11flash_wgmmaILi128ELi2ELb1EEEv
        /*0c50*/                   WARPGROUP.ARRIVE ;
        /*0c80*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT, gsb0 ;
        /*0c90*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0d50*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*16d0*/                   STL.64 [R1+0x88], R202 ;
        /*16e0*/              @!P0 LDL.LU.64 R32, [R1+0x20] ;
\t\tFunction : _ZN4anon9flash_fwdIfLi64ELi64EEEv
        /*0010*/                   STL [R1], R250 ;
"""

    class Run:
        stdout = listing
    monkeypatch.setattr(flash_variants.subprocess, "run",
                        lambda *a, **k: Run())
    monkeypatch.setattr(flash_variants.build, "nvcc_path",
                        lambda: "/cuda/bin/nvcc")
    assert flash_variants.sass_stats("lib.so") == {128: {
        "max_register": 202, "hgmma": 2, "wgmma_waits": 1, "local_loads": 1,
        "local_stores": 1}}
