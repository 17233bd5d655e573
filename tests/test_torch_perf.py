"""The port's roofline tooling against the reference's: the shape cells,
the abstract inputs, ``active_params`` / ``model_flops`` /
``roofline_terms``, every scheme's ``flops_bytes`` and
``tree_flops_bytes`` on the same weights (carried across by
``repro_torch.bridge``), and the cost counter (``repro_torch.perf.cost``)
against ``repro.perf.hlo_analysis`` and across routes (CPU, ``meta``).
Numbers are held exactly unless a tolerance is stated."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.configs.shapes import input_specs as ref_input_specs  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.perf import roofline as rroof  # noqa: E402
from repro.perf.hlo_analysis import analyze_hlo_text  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.shapes import input_specs  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               trainable_tensors)
from repro_torch.perf import roofline as troof  # noqa: E402
from repro_torch.perf.cost import CostCounter, OpCost  # noqa: E402
from _torch_parity import bump, numpy_tree  # noqa: E402

TPU = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


# ---------------------------------------------------------------------------
# shape cells and abstract inputs
# ---------------------------------------------------------------------------


def test_shape_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rbase.SHAPES.items()}
    assert tbase.SUBQUADRATIC == rbase.SUBQUADRATIC
    assert list(TC.REGISTRY) == list(RC.REGISTRY)
    for arch in RC.REGISTRY:
        assert [dataclasses.astuple(c) for c in tbase.cells_for(arch)] == \
            [dataclasses.astuple(c) for c in rbase.cells_for(arch)], arch
    assert TC.ASSIGNED == RC.ASSIGNED


def _ref_dtype(dt):
    return {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
            jnp.float32: torch.float32}[jnp.dtype(dt).type]


def _leaf_shapes(tree, torch_side):
    """``{path: shape}`` of a nested dict of arrays or tensors."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            out[prefix] = tuple(node.shape)
    walk((), tree)
    return out


@pytest.mark.parametrize("arch", RC.ASSIGNED)
def test_input_specs_equal_the_reference(arch):
    """Every cell of every assigned config: the step kind and each input's
    shape; batch dtypes mapped to the port's; the decode cache against
    ``jax.eval_shape`` of the reference's ``LM.init_cache`` (no mesh)."""
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    for cell in rbase.cells_for(arch):
        rkind, rkw = ref_input_specs(rcfg, cell)
        tkind, tkw = input_specs(tcfg, tbase.SHAPES[cell.name])
        assert rkind == tkind
        assert set(rkw) == set(tkw)
        for key in rkw:
            want, got = rkw[key], tkw[key]
            if key == "batch":
                assert set(want) == set(got)
                for k in want:
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == want[k].shape, (arch, k)
                    assert got[k].dtype == _ref_dtype(want[k].dtype)
            elif key == "tokens":
                assert tuple(got.shape) == want.shape
                assert got.dtype == torch.int32
            else:  # the cache
                assert _leaf_shapes(got, True) == _leaf_shapes(want, False), \
                    (arch, cell.name)
                assert all(t.device.type == "meta"
                           for t in jax.tree.leaves(got))


# ---------------------------------------------------------------------------
# roofline formulas
# ---------------------------------------------------------------------------


def test_active_params_and_model_flops_equal_the_reference():
    for arch in RC.REGISTRY:
        rcfg, tcfg = RC.get(arch), TC.get(arch)
        assert troof.active_params(tcfg) == rroof.active_params(rcfg), arch
        for cell in rbase.cells_for(arch):
            assert troof.model_flops(tcfg, tbase.SHAPES[cell.name]) == \
                rroof.model_flops(rcfg, cell), (arch, cell.name)
    assert troof.active_params(TC.get("gemma3-1b")) == 1_301_741_568


def test_roofline_terms_with_the_reference_hw_equal_the_reference():
    from repro.perf.hlo_analysis import HLOCost
    cost = OpCost(flops=12_345_678_901, bytes=987_654_321,
                  collective_bytes=55_555_555)
    ref = HLOCost(flops=cost.flops, bytes=cost.bytes,
                  collective_bytes=cost.collective_bytes)
    for arch, cell in (("gemma3-1b", "train_4k"), ("mixtral-8x22b",
                                                   "decode_32k")):
        got = troof.roofline_terms(cost, 256, TC.get(arch),
                                   tbase.SHAPES[cell], troof.HW(**TPU))
        want = rroof.roofline_terms(ref, 256, RC.get(arch),
                                    rbase.SHAPES[cell], rroof.HW())
        assert got == want
    h100 = troof.HW()
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw,
            h100.peak_f32_flops) == (989e12, 3.35e12, 450e9, 67e12)


# ---------------------------------------------------------------------------
# scheme costs
# ---------------------------------------------------------------------------


def _pol(mode):
    return RS.QuantPolicy(mode=mode, bits=4, group_size=32, rank=4,
                          dtype=jnp.float32, scale_dtype=jnp.float32)


def _port_linear(lp):
    return bridge._linear(numpy_tree(lp), TC.reduced("gemma3-1b"), "x",
                          "cpu")


@pytest.mark.parametrize("m", [1, 4, 512])
def test_scheme_flops_bytes_equal_the_reference(m):
    """The six schemes on the same weights (cf. the reference's
    ``test_flops_bytes_accounting``), and the tree walk over them."""
    key = jax.random.PRNGKey(0)
    ref, port = {}, {}
    for mode in ("fp", "lora", "qlora", "qalora", "intq"):
        lp = RS.linear_init(key, 128, 64, _pol(mode))
        ref[mode], port[mode] = lp, _port_linear(lp)
        want = RS.get_scheme(mode).flops_bytes(lp.data, lp.policy, m)
        got = TS.get_scheme(mode).flops_bytes(port[mode].data,
                                              port[mode].policy, m)
        assert got == tuple(int(v) for v in want), mode
        assert all(type(v) is int for v in got)
    # qalora_slot: a 3-adapter bank over the qalora base
    qa = ref["qalora"]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4, 64)).astype(np.float32)
    rdata = {"q": RS.quantized_base(qa), "a": jnp.asarray(a),
             "b": jnp.asarray(b), "ids": jnp.zeros((m,), jnp.int32)}
    pq = TS.quantized_base(port["qalora"])
    tdata = {"q": pq, "a": torch.from_numpy(a), "b": torch.from_numpy(b),
             "ids": torch.zeros((m,), dtype=torch.int32)}
    assert TS.get_scheme("qalora_slot").flops_bytes(tdata, None, m) == \
        tuple(int(v) for v in RS.get_scheme("qalora_slot").flops_bytes(
            rdata, qa.policy, m))
    assert TS.get_scheme("qalora_slot").stack_ndim(tdata) == 0
    for mode in port:
        assert TS.get_scheme(mode).stack_ndim(port[mode].data) == \
            RS.get_scheme(mode).stack_ndim(ref[mode].data)
    assert TS.tree_flops_bytes(port, m) == tuple(
        int(v) for v in RS.tree_flops_bytes(ref, m))


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b"])
def test_tree_flops_bytes_equal_the_reference(arch):
    """A reduced model's every linear (the reference stacks layers and
    experts on leading axes, the port holds one module each)."""
    params = bump(RLM(RC.reduced(arch)).init(jax.random.PRNGKey(0)))
    tparams = bridge.load_numpy_tree(numpy_tree(params), TC.reduced(arch),
                                     "cpu")
    meta = TLM(TC.reduced(arch)).init(torch.Generator(), "meta")
    for m in (1, 4, 512):
        want = tuple(int(v) for v in RS.tree_flops_bytes(params, m))
        assert TS.tree_flops_bytes(tparams, m) == want, (arch, m)
        assert TS.tree_flops_bytes(meta, m) == want, (arch, m)


def test_meta_params_at_full_width_give_the_decode_floor():
    """llama7b-proxy's 224 merged INT4 linears on ``meta``: their bytes
    over the H100's HBM rate are the 1.21 ms decode floor."""
    lm = TLM(TC.get("llama7b-proxy"))
    merged = TS.merge_tree(steps.abstract_params(lm))
    linears = [m for m in merged.blocks.modules() if TS.is_linear(m)]
    assert len(linears) == 224
    assert {lp.scheme for lp in linears} == {"intq"}
    flops, nbytes = TS.tree_flops_bytes(merged.blocks, 1)
    assert nbytes == 4_047_503_360
    assert flops == 2 * 6_476_005_376
    assert round(nbytes / troof.HW().hbm_bw * 1e3, 2) == 1.21


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------


def test_loop_of_products_counts_every_trip():
    """The counterpart of the reference's
    ``test_while_trip_count_multiplication``: a Python loop of 8 products
    counts 8 times, as its unrolled twin."""
    w = torch.randn(128, 128)
    x = torch.randn(32, 128)
    with CostCounter() as c:
        for _ in range(8):
            x = torch.tanh(x @ w)
    assert c.cost.flops == 8 * 2 * 32 * 128 * 128
    assert c.by_op["mm"][0] == 8
    # operands and result of each product; tanh fuses
    assert c.cost.bytes == 8 * 4 * (32 * 128 + 128 * 128 + 32 * 128)


def test_batched_product_counts_2bmkn():
    a, b = torch.randn(4, 16, 32), torch.randn(4, 32, 8)
    with CostCounter() as c:
        a @ b
    assert c.cost.flops == 2 * 4 * 16 * 8 * 32


def test_data_movement_rules():
    x = torch.randn(8, 16)
    idx = torch.tensor([1, 3])
    with CostCounter() as c:
        x.sum(dim=0)                        # operand + result
    assert c.cost == OpCost(0, 4 * (8 * 16 + 16))
    with CostCounter() as c:
        x[idx]                              # a gather: result twice
    assert c.cost == OpCost(0, 2 * 4 * 2 * 16)
    with CostCounter() as c:
        x[idx] = torch.ones(2, 16)          # a scatter: update twice
    assert c.cost.bytes == 2 * 4 * 2 * 16
    with CostCounter() as c:
        torch.exp(x) * 2 + x                # elementwise: fused
    assert c.cost == OpCost()


def _prefill_inputs(device):
    return {"tokens": torch.arange(128, dtype=torch.int32,
                                   device=device).reshape(2, 64) % 256}


def test_counter_dot_flops_match_the_reference_hlo_walker():
    """The port's prefill of reduced gemma3-1b (2 x 64 tokens) counts the
    reference's ``analyze_hlo_text`` of ``jax.jit(lm.prefill)`` flops to
    within 2 % (they agree exactly: both count every dot of the same
    linears, the same chunked attention and the last row's head)."""
    rcfg = RC.reduced("gemma3-1b")
    rlm = RLM(rcfg)
    params = rlm.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((2, 64), jnp.int32)}
    text = jax.jit(rlm.prefill).lower(params, batch).compile().as_text()
    want = analyze_hlo_text(text).flops
    tparams = bridge.load_numpy_tree(numpy_tree(params), TC.reduced(
        "gemma3-1b"), "cpu")
    with CostCounter() as c:
        TLM(TC.reduced("gemma3-1b")).prefill(tparams, _prefill_inputs("cpu"))
    assert abs(c.cost.flops - want) <= 0.02 * want
    assert c.cost.flops == want == 19_853_312


def _three_steps(device, arch="gemma3-1b"):
    """The OpCost of one prefill, one remat train step and one decode step
    of a reduced config on ``device``."""
    cfg = TC.reduced(arch).scaled(remat=True)
    lm = TLM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device)
    batch = _prefill_inputs(device)
    with CostCounter() as pre, torch.no_grad():
        lm.prefill(params, batch)
    step = steps.make_train_fn(lm, AdamWConfig())
    opt = adamw_init(trainable_tensors(params))
    with CostCounter() as train:
        step(params, opt, {**batch, "labels": batch["tokens"]})
    cache = lm.init_cache(2, 80, device=device)
    with CostCounter() as dec, torch.no_grad():
        lm.decode_step(params, cache, batch["tokens"][:, :1])
    return pre.cost, train.cost, dec.cost


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b"])
def test_cpu_and_meta_count_the_same_step(arch):
    """Route independence: the same steps counted on CPU tensors (the
    kernels' plain versions) and on ``meta`` tensors (shapes alone) give
    equal OpCosts."""
    cpu, meta = _three_steps("cpu", arch), _three_steps("meta", arch)
    assert cpu == meta
    assert all(c.flops > 0 and c.bytes > 0 for c in cpu)


def test_kernel_entry_points_take_the_plain_route_on_meta():
    """Every entry point of ``kernels.ops`` on ``meta`` tensors: meta
    outputs of the right shapes, no kernel launched, and one costed
    operation each (the scheme's flops and weight bytes plus the
    activation's bytes), whichever of the GEMV or tiled dispatch."""
    from repro_torch import kernels
    w = torch.randn(128, 64)
    qt = tquant.quantize(w, 4, 32, scale_dtype=torch.bfloat16)
    meta = tquant.QuantizedLinear(*(t.to("meta") for t in (
        qt.qweight, qt.scale, qt.zero)), 4, 32)
    from repro_torch.core.qalora import QALoRAParams
    ad = QALoRAParams(torch.empty(4, 8, device="meta", dtype=torch.bfloat16),
                      torch.empty(8, 64, device="meta", dtype=torch.bfloat16))
    a_bank = torch.empty(3, 4, 8, device="meta", dtype=torch.bfloat16)
    b_bank = torch.empty(3, 8, 64, device="meta", dtype=torch.bfloat16)
    kernels.reset_launches()
    for m in (4, 40):
        x = torch.empty(2, m // 2, 128, device="meta", dtype=torch.bfloat16)
        ids = torch.zeros(2, m // 2, device="meta", dtype=torch.int32)
        act = (m * 128 + m * 64) * 2
        cases = (
            ("intq", {"q": meta}, lambda: ops.qmatmul(x, meta)),
            ("qalora", {"q": meta, "ad": ad},
             lambda: ops.qalora_matmul(x, meta, ad, s=2.0)),
            ("qalora_slot", {"q": meta, "a": a_bank, "b": b_bank},
             lambda: ops.qalora_slot_matmul(x, meta, a_bank, b_bank, ids)))
        for scheme, data, call in cases:
            with CostCounter() as c:
                y = call()
            assert y.device.type == "meta" and tuple(y.shape) == (2, m // 2,
                                                                  64)
            f, b = TS.get_scheme(scheme).flops_bytes(data, None, m)
            assert c.cost == OpCost(f, b + act), (scheme, m)
    q = torch.empty(1, 256, 4, 64, device="meta", dtype=torch.bfloat16)
    with CostCounter() as c:
        o = ops.flash_mha(q, q, q, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape
    assert c.cost == OpCost(2 * 4 * 256 * 256 * 128, 4 * q.numel() * 2)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}
