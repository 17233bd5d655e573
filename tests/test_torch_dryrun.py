"""The port's dry run (``repro_torch.launch.dryrun``): a rank's program of
a production mesh built on ``meta`` under a fake process group, against
the reference's sharding of the same configs, and its roofline table
(``repro_torch.launch.roofline_report``).

A rank's parameter bytes are held to the reference's ``param_specs``
over an ``AbstractMesh`` of the same shape on ``jax.eval_shape`` of its
``LM.init``, for every assigned config on both production meshes, at the
configs' full widths with two layers of each stack (the rules never
shard a layer axis).  Three cells are traced: reduced gemma3-1b's train
step on data 2 x model 2 (at 8 x 64 tokens: the reduced config's chunks
of 16 make the full train_4k cell's plain attention loop 65536 chunk
pairs a layer), llama7b-proxy's decode_32k on the pod, and a refused
family.  A rank's parameter bytes count the reference's expert
parallelism (deepseek-v3's 256 experts over data x model: one a rank),
and the port's shard holds exactly those.  The MoE families' train and
prefill cells are traced at the reduced scale on data 2 x model 2
(expert dispatch and combine counted as collectives).  Decode on the pod:
mixtral-8x22b's decode_32k (its 8 KV heads' head_dim over "model", the
partial scores summed) and deepseek-v3-671b's (at two of its 61 layers:
its latent and rope key over "model", gathered whole, the bytes
``roofline_report.mla_decode_exchange`` gives), gemma3-1b's decode_32k
(one KV head's head_dim split) and long_500k (batch 1: the positions
over "data", merged by log-sum-exp), each with the cache bytes a rank
holds."""

import json
import math

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.sharding import param_specs as ref_param_specs  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.launch import dryrun, roofline_report  # noqa: E402
from repro_torch.launch.steps import check_mesh_support  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.perf.cost import tensor_bytes  # noqa: E402
from repro_torch.perf.roofline import HW  # noqa: E402
from repro_torch.sharding import rank_param_bytes, shard_params  # noqa: E402


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _cut(cfg):
    """Full widths, two layers of each stack."""
    cut = {"n_layers": 2}
    if cfg.family == "mla_moe":
        cut["n_dense_layers"] = 1
    if cfg.family == "encdec":
        cut["n_enc_layers"] = 1
    if cfg.family == "mamba_hybrid":
        cut["n_layers"] = cfg.attn_every + 1
    return cut


def _ref_rank_bytes(tree, specs, shape):
    """A rank's bytes of the reference's leaves under their specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, s in zip(leaves, sp):
        split = 1
        for axes in s:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                if a is not None:
                    split *= shape[a]
        total += math.prod(x.shape) // split * x.dtype.itemsize
    return total


@pytest.fixture(scope="module", params=RC.ASSIGNED)
def trees(request):
    arch = request.param
    cut = _cut(RC.get(arch))
    ref = jax.eval_shape(RLM(RC.get(arch).scaled(**cut)).init,
                         jax.random.PRNGKey(0))
    port = TLM(TC.get(arch).scaled(**cut)).init(torch.Generator(), "meta")
    return arch, ref, port


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_rank_param_bytes_equal_the_reference(trees, mesh):
    arch, ref, port = trees
    sizes, names = dryrun.MESHES[mesh]
    want = _ref_rank_bytes(ref, ref_param_specs(
        ref, _abstract_mesh(sizes, names)), dict(zip(names, sizes)))
    with dryrun.fake_mesh(sizes, names, rank=5) as m:
        got = rank_param_bytes(port, m)
        # the shard the rank holds (its experts only, where they split)
        shard = shard_params(port, m)
        assert tensor_bytes(*shard.buffers(),
                            *shard.parameters()) == got, arch
    assert got == want, arch
    assert got < tensor_bytes(*port.buffers(), *port.parameters())


def test_reduced_gemma_train_step_on_a_2x2_mesh():
    """Rank 3 of data 2 x model 2: the train step of the shard counted on
    ``meta``, with the Megatron operators' and the gradient sums'
    collectives, and its held bytes equal to the reference's sharding."""
    cfg = TC.reduced("gemma3-1b")
    cell = ShapeCell("train_4k", "train", 64, 8)
    with dryrun.fake_mesh((2, 2), ("data", "model"), rank=3) as m:
        rec = dryrun.trace(cfg, cell, m)
    one = dryrun.trace(cfg, cell)
    rcfg = RC.reduced("gemma3-1b")
    ref = jax.eval_shape(RLM(rcfg).init, jax.random.PRNGKey(0))
    want = _ref_rank_bytes(ref, ref_param_specs(
        ref, _abstract_mesh((2, 2), ("data", "model"))),
        {"data": 2, "model": 2})
    assert rec["memory"]["params_bytes"] == want
    assert rec["memory"]["batch_bytes"] == 2 * 4 * 64 * 4  # 4 rows a rank
    assert rec["cost"]["collective_bytes"] > 0
    assert one["cost"]["collective_bytes"] == 0
    assert 0 < rec["cost"]["flops"] < one["cost"]["flops"]
    assert rec["by_op"]["all_reduce"]["calls"] > 0
    assert rec["by_op"]["qalora_matmul"]["calls"] > 0


@pytest.mark.parametrize("arch,kind", (("mixtral-8x22b", "train"),
                                       ("deepseek-v3-671b", "prefill")))
def test_reduced_moe_cell_on_a_2x2_mesh(arch, kind):
    """Rank 3 of data 2 x model 2 (full expert parallelism: one of 4
    experts a rank): the cell counted on ``meta``, its held bytes the
    reference's sharding, and its cost one device's with the collectives
    counted: the ranks' kernel-3 FLOPs together one device's, plus only
    the replicated rank projections of the column linears (within 2%),
    the dispatch and combine as all-to-alls and all-gathers."""
    cfg = TC.reduced(arch)
    cell = ShapeCell(f"{kind}_cell", kind, 64, 8)
    with dryrun.fake_mesh((2, 2), ("data", "model"), rank=3) as m:
        rec = dryrun.trace(cfg, cell, m)
    one = dryrun.trace(cfg, cell)
    rcfg = RC.reduced(arch)
    ref = jax.eval_shape(RLM(rcfg).init, jax.random.PRNGKey(0))
    want = _ref_rank_bytes(ref, ref_param_specs(
        ref, _abstract_mesh((2, 2), ("data", "model"))),
        {"data": 2, "model": 2})
    assert rec["memory"]["params_bytes"] == want
    flops = 4 * rec["by_op"]["qalora_matmul"]["flops"]
    base = one["by_op"]["qalora_matmul"]["flops"]
    assert base <= flops <= 1.02 * base
    assert rec["by_op"]["all_to_all"]["calls"] > 0
    assert rec["cost"]["collective_bytes"] > 0
    assert one["cost"]["collective_bytes"] == 0
    assert 0 < rec["cost"]["flops"] < one["cost"]["flops"]
    # the roofline row shows the expert exchange's all-to-all term
    row = roofline_report.analyze({**rec, "arch": arch, "mesh": "2x2",
                                   "cell": "train_4k" if kind == "train"
                                   else "prefill_32k", "n_devices": 4,
                                   "reduced": True})
    a2a = rec["by_op"]["all_to_all"]["collective_bytes"] / 450e9
    assert row["all_to_all_s"] == a2a
    assert 0 < a2a < row["collective_s"]
    assert f"| {roofline_report.fmt_s(a2a)} |" in roofline_report.table([row])


def _decode_record(arch, cell, tmp_path, layers=None):
    """A decode cell as rank 0 of the pod: ``run_cell``'s record, or at
    ``layers`` (mla_moe: the first dense) the trace of the cut config."""
    if layers is None:
        return dryrun.run_cell(arch, cell, "pod", outdir=str(tmp_path))
    cfg = TC.get(arch).scaled(n_layers=layers, n_dense_layers=1)
    with dryrun.fake_mesh(*dryrun.MESHES["pod"]) as m:
        rec = dryrun.trace(cfg, SHAPES[cell], m)
    return {**rec, "ok": True, "status": "ok", "arch": arch, "cell": cell,
            "mesh": "pod", "n_devices": 256}


# (arch, cell, layers traced, labelled collectives present, cache bytes a
# rank: every layer's leaves and its rows' lengths)
DECODE_CELLS = {
    "mixtral_decode": ("mixtral-8x22b", "decode_32k", None, ("score_sum",),
                       2 * 56 * 8 * 32768 * 8 * 8 * 2 + 8 * 4),
    "deepseek_decode": ("deepseek-v3-671b", "decode_32k", 2,
                        ("latent_gather",),
                        2 * 8 * 32768 * (32 + 4) * 2 + 8 * 4),
    "gemma_decode": ("gemma3-1b", "decode_32k", None, ("score_sum",),
                     2 * 26 * 8 * 32768 * 16 * 2 + 8 * 4),
    "gemma_long": ("gemma3-1b", "long_500k", None,
                   ("score_sum", "lse_merge"),
                   2 * 26 * 32768 * 16 * 2 + 4)}


@pytest.mark.parametrize("name", list(DECODE_CELLS))
def test_decode_cells_on_the_pod(name, tmp_path):
    """The decode cells the cache spec splits otherwise than by whole KV
    heads are ok on the pod: a rank holds its part of the cache (batch
    rows 8 of 128, or 32768 of long_500k's 524288 positions; head_dim 16
    of 256 or 8 of 128; MLA's latent 32 of 512 and rope key 4 of 64) and
    fits the card; the roofline row names its decode collectives."""
    arch, cell, layers, labels, cache_bytes = DECODE_CELLS[name]
    rec = _decode_record(arch, cell, tmp_path, layers)
    assert rec["ok"] and rec["status"] == "ok", rec.get("reason")
    mem = rec["memory"]
    assert mem["cache_bytes"] == cache_bytes
    assert mem["fits"]
    row = roofline_report.analyze(rec)
    for label in labels:
        assert 0 < row[f"{label}_s"] < row["collective_s"]
    for label in set(roofline_report.DECODE_COLLECTIVES) - set(labels):
        assert row[f"{label}_s"] == 0
    if arch == "deepseek-v3-671b":
        # the latent gathered: the smaller exchange, as counted
        sizes = roofline_report.mla_decode_exchange(TC.get(arch), 8, 32768,
                                                    16)
        got = rec["by_op"]["all_gather[latent_gather]"]
        assert got["calls"] == 2 * layers
        assert got["collective_bytes"] == layers * sizes["gather_latent"]
        assert sizes["gather_latent"] < sizes["sum_scores"]


def test_llama_decode_on_the_pod_and_its_roofline_row(tmp_path):
    """llama7b-proxy's decode_32k as rank 0 of the 16 x 16 pod: 8 rows and
    2 of 32 KV heads a rank, the table's row from the H100 figures."""
    rec = dryrun.run_cell("llama7b-proxy", "decode_32k", "pod",
                          outdir=str(tmp_path))
    assert rec["ok"] and rec["status"] == "ok" and rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["cache_bytes"] == 2 * 32 * 8 * 32768 * 2 * 128 * 2 + 8 * 4
    assert mem["fits"] and mem["total_bytes"] < HW().hbm_bytes
    assert rec["cost"]["collective_bytes"] > 0
    assert rec["by_op"]["qalora_matmul"]["calls"] == 32 * 7
    with open(tmp_path / "llama7b-proxy__decode_32k__pod.json") as f:
        assert json.load(f)["cost"] == rec["cost"]
    row = roofline_report.analyze(rec)
    assert row["compute_s"] == rec["cost"]["flops"] / 989e12
    assert row["memory_s"] == rec["cost"]["bytes"] / 3.35e12
    assert row["collective_s"] == rec["cost"]["collective_bytes"] / 450e9
    assert row["dominant"] == "memory_s"
    assert "| llama7b-proxy | decode_32k | pod |" in \
        roofline_report.table([row])


def test_a_refused_family_is_recorded_with_its_reason(tmp_path):
    rec = dryrun.run_cell("rwkv6-7b", "train_4k", "multipod",
                          outdir=str(tmp_path))
    assert not rec["ok"] and rec["status"] == "refused"
    with pytest.raises(NotImplementedError) as e:
        check_mesh_support(TC.get("rwkv6-7b"), {"qalora"})
    assert rec["reason"] == str(e.value)
    assert "ROADMAP.md" in rec["reason"]
