"""The port's sharded train step on a mesh of CPU processes (gloo) against
the reference's single-device step, the int8 cross-pod sync, elastic
checkpoints, the merge on a mesh, and the refusals.

Each test spawns its mesh's ranks through
:func:`repro_torch.launch.mesh.run_ranks`, which joins them within a
deadline and kills the ones left.  The reference runs in this process
with no mesh: ``jax.jit(make_train_fn(...))`` on the same numpy weights
(``LM.init`` with the adapters nudged by +0.01) and batches; its sharded
step cannot run here (ROADMAP.md: the reference's mesh fault).  The
bound is ``tests/test_torch_train.py``'s: 1e-5 of each tensor's largest
magnitude, plus the AdamW allowance for the adapters.  The ranks import
this module, not JAX: the reference's side is imported where it runs.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.launch import steps as S
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_cpu_mesh, make_mesh, run_ranks
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import AdamWConfig, adamw_init, trainable_tensors
from repro_torch.optim.compression import compressed_mean
from repro_torch.sharding import (gather_params, gather_tensors, rules,
                                  shard_params, tp_of)

LR = 2e-4
SEQ = 32
DEADLINE = 150.0


def _batches(n_rows, seed, uneven=True):
    """Three [n_rows, SEQ] batches; with ``uneven`` the first half of the
    rows (the first DP rank's) has most labels masked and a row with none,
    the second half few."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        toks = rng.integers(4, 256, size=(n_rows, SEQ)).astype(np.int32)
        labs = rng.integers(0, 256, size=(n_rows, SEQ)).astype(np.int32)
        if uneven:
            half = n_rows // 2
            labs[:half][rng.random((half, SEQ)) < 0.7] = -1
            labs[0] = -1
            labs[half:][rng.random((n_rows - half, SEQ)) < 0.1] = -1
        out.append((toks, labs))
    return out


def _tb(toks, labs):
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}


# --- what the ranks run (module level: pickled by name) ---------------------


def _trajectory(mesh, arch, tree, batches, over=None):
    """Three sharded steps from ``tree`` on ``TC.reduced(arch, **over)``;
    after each the loss, grad norm, and the gathered adapters and moments
    in the bridge's layout."""
    cfg = TC.reduced(arch, **(over or {}))
    lm = TLM(cfg)
    full = bridge.load_numpy_tree(tree, cfg, "cpu")
    shard = shard_params(full, mesh)
    tr = trainable_tensors(shard)
    opt = adamw_init(tr)
    step = S.make_train_step(lm, mesh, AdamWConfig(lr=LR))
    out = []
    for toks, labs in batches:
        m = step(shard, opt, _tb(toks, labs))
        rec = {k: float(m[k]) for k in ("loss", "xent", "grad_norm", "lr")}
        for key, vals in (("adapters", tr), ("mu", opt["mu"]),
                          ("nu", opt["nu"])):
            rec[key] = bridge.adapters_numpy(
                full, gather_tensors(vals, shard.specs, mesh))
        rec["step"] = int(opt["step"])
        out.append(rec)
    return out, shard


def _modes(shard):
    return {name: tp_of(lp).mode.value for name, lp in shard.named_modules()
            if tp_of(lp) is not None}


def rank_steps(rank, sizes, axes, cases, control, merge=False):
    """Each case (arch, tree, batches) trained three steps on the mesh
    (with ``merge``, then merged: the merged shards gathered, and the
    gathered tree merged); with ``control`` also one step of the first
    case with the "model" sum of the column linears' A gradients left
    out."""
    from repro_torch.core.schemes import merge_tree
    mesh = make_mesh(sizes, axes)
    out = []
    for arch, tree, batches, *over in cases:
        rec, shard = _trajectory(mesh, arch, tree, batches, *over)
        out.append({"steps": rec, "modes": _modes(shard)})
        if merge:
            out[-1]["merged"] = (
                bridge.numpy_tree(gather_params(merge_tree(shard), mesh)),
                bridge.numpy_tree(merge_tree(gather_params(shard, mesh))))
    if control:
        real = S.model_partial_leaves
        S.model_partial_leaves = lambda p: {
            n for n in real(p) if not n.endswith(".ad.a")}
        try:
            arch, tree, batches = cases[0]
            out.append({"steps": _trajectory(mesh, arch, tree,
                                             batches[:1])[0]})
        finally:
            S.model_partial_leaves = real
    return out


CLI = ["--reduced", "--device", "cpu", "--seq-len", str(SEQ),
       "--global-batch", "4", "--ckpt-every", "2", "--log-every", "100"]


def _cli(mesh, argv):
    """setup + run of the train CLI on ``mesh``; the gathered adapters and
    moments, and the losses."""
    args = ttrain.build_parser().parse_args(CLI + argv)
    st = ttrain.setup(args, mesh=mesh)
    rec = ttrain.run(st, args) if args.steps > st.start else {"loss": []}
    specs = getattr(st.params, "specs", {})
    return {"loss": rec["loss"], "start": st.start,
            "t": {k: v.numpy() for k, v in
                  gather_tensors(st.trainable, specs, mesh).items()},
            **{k: {n: v.numpy() for n, v in gather_tensors(
                st.opt_state[k], specs, mesh).items()} for k in ("mu", "nu")}}


def rank_checkpoints(rank, sizes, axes, whole, cut):
    """An uninterrupted 4-step run, and one cut at step 2 and resumed."""
    mesh = make_mesh(sizes, axes)
    base = ["--arch", "llama7b-proxy", "--mesh", "pod"]
    return (_cli(mesh, base + ["--steps", "4", "--ckpt-dir", whole]),
            _cli(mesh, base + ["--steps", "2", "--ckpt-dir", cut]),
            _cli(mesh, base + ["--steps", "4", "--ckpt-dir", cut]))


def rank_restore(rank, sizes, axes, ckpt):
    """The checkpoint restored onto this mesh, gathered back."""
    mesh = make_mesh(sizes, axes)
    return _cli(mesh, ["--arch", "llama7b-proxy", "--mesh", "pod",
                       "--steps", "4", "--ckpt-dir", ckpt])


def rank_unshared(rank, sizes, axes, ckpt, empty):
    """The resume of ``ckpt`` with rank 0 reading it and the other ranks
    an empty directory: each rank's refusal."""
    mesh = make_mesh(sizes, axes)
    try:
        _cli(mesh, ["--arch", "llama7b-proxy", "--mesh", "pod", "--steps",
                    "4", "--ckpt-dir", ckpt if rank == 0 else empty])
    except ValueError as e:
        return str(e)
    return None


def rank_sync(rank, sizes, axes, values, tree, batches):
    """``compressed_mean`` of this pod's ``values``; one step of the CLI
    with ``--sync-every 1`` on reduced gemma3-1b: the adapters before and
    after the sync; and a 2-step CLI run with ``--sync-every 1``."""
    mesh = make_mesh(sizes, axes)
    mine = {k: torch.from_numpy(v[mesh.index("pod")]) for k, v in
            values.items()}
    mean = {k: v.numpy() for k, v in compressed_mean(mine, mesh).items()}
    cfg = TC.reduced("gemma3-1b")
    full = bridge.load_numpy_tree(tree, cfg, "cpu")
    shard = shard_params(full, mesh)
    tr = trainable_tensors(shard)
    opt = adamw_init(tr)
    S.make_train_step(TLM(cfg), mesh, AdamWConfig(lr=LR))(
        shard, opt, _tb(*batches[0]))
    before = gather_tensors(tr, shard.specs, mesh)
    S.make_sync_step(mesh)(tr)
    after = gather_tensors(tr, shard.specs, mesh)
    cli = _cli(mesh, ["--arch", "gemma3-1b", "--mesh", "multipod",
                      "--steps", "2", "--sync-every", "1"])
    return (mean, {k: v.numpy() for k, v in before.items()},
            {k: v.numpy() for k, v in after.items()}, cli["t"])


# --- the reference's side ----------------------------------------------------


def _ref(arch, **over):
    """The reference's params on ``RC.reduced(arch, **over)``, their numpy
    tree and the jitted ``make_train_fn`` step."""
    import jax
    from _torch_parity import bump, numpy_tree
    import repro.configs as RC
    from repro.launch.steps import make_train_fn
    from repro.models.lm import LM as RLM
    from repro.optim import AdamWConfig as RAdamW
    lm = RLM(RC.reduced(arch, **over))
    params = bump(lm.init(jax.random.PRNGKey(0)))
    return SimpleNamespace(params=params, tree=numpy_tree(params),
                           step=jax.jit(make_train_fn(lm, RAdamW(lr=LR))))


def _ref_run(ref, batches):
    """The reference's single-device step over ``batches``: per step the
    loss, grad norm, adapters and moments in the bridge's layout."""
    import jax.numpy as jnp
    from _torch_parity import ref_adapters
    from repro.optim import adamw_init as ref_adamw_init
    from repro.optim import split_params
    step = ref.step
    tr, fr = split_params(ref.params)
    opt = ref_adamw_init(tr)
    out = []
    for toks, labs in batches:
        tr, opt, m = step(tr, fr, opt, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labs)})
        out.append({"loss": float(m["loss"]), "xent": float(m["xent"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]), "adapters": ref_adapters(tr),
                    "mu": ref_adapters(opt["mu"]),
                    "nu": ref_adapters(opt["nu"]), "step": int(opt["step"])})
    return out


def _check(got, want):
    """The bound of tests/test_torch_train.py on every step: metrics and
    moments within 1e-5; the adapters after steps 1 and 3 within 1e-5
    plus the AdamW allowance of the steps so far."""
    from test_torch_train import _adam_allowance, _close
    cfg = AdamWConfig(lr=LR)
    moments = []
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "xent", "grad_norm", "lr"):
            _close(np.float64(g[k]), np.float64(w[k]), where=f"{i}/{k}")
        assert g["step"] == w["step"] == i + 1
        _close(g["mu"], w["mu"], where=f"{i}/mu")
        _close(g["nu"], w["nu"], where=f"{i}/nu")
        moments.append(((g["mu"], g["nu"]), (w["mu"], w["nu"])))
        if i in (0, 2):
            _close(g["adapters"], w["adapters"], where=f"{i}/adapters",
                   allow=_adam_allowance(moments, cfg))


@pytest.fixture(scope="module")
def refs():
    """Each arch's :func:`_ref`; llama's runs recompute each block in the
    backward, as the card's."""
    pytest.importorskip("jax")
    return {"gemma3-1b": _ref("gemma3-1b"),
            "llama7b-proxy": _ref("llama7b-proxy", remat=True)}


# --- the sharded step --------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_2x2(refs):
    """reduced gemma3-1b on data 2 x model 2: labels masked unevenly over
    the DP ranks (4 rows), a batch of 3 rows (replicated over DP), and the
    control."""
    r = refs["gemma3-1b"]
    cases = [("gemma3-1b", r.tree, _batches(4, 1)),
             ("gemma3-1b", r.tree, _batches(3, 2, uneven=False))]
    got = run_ranks(rank_steps, 4, ((2, 2), ("data", "model"), cases, True),
                    deadline_s=DEADLINE)
    want = [_ref_run(r, b) for _, _, b in cases]
    return got, want


def test_sharded_step_matches_reference_on_data2_model2(gemma_2x2):
    got, want = gemma_2x2
    for rank in got:
        _check(rank[0]["steps"], want[0])


def test_replicated_batch_is_not_summed_over_dp(gemma_2x2):
    """3 rows do not split over data 2: every rank takes all of them, and
    the step equals the reference's (a DP sum would double the gradient)."""
    got, want = gemma_2x2
    for rank in got:
        _check(rank[1]["steps"], want[1])


def test_control_without_the_column_a_reduction_fails(gemma_2x2):
    from test_torch_train import _close
    got, want = gemma_2x2
    ctl = got[0][2]["steps"][0]
    with pytest.raises(AssertionError):
        _close(ctl["mu"], want[0][0]["mu"])


@pytest.fixture(scope="module")
def gemma_model4(refs):
    r = refs["gemma3-1b"]
    cases = [("gemma3-1b", r.tree, _batches(4, 3))]
    got = run_ranks(rank_steps, 4, ((1, 4), ("data", "model"), cases, False,
                                    True), deadline_s=DEADLINE)
    return got, _ref_run(r, cases[0][2])


def test_gemma_on_model4_splits_kv_heads_and_runs_mid_group_down_whole(
        gemma_model4):
    """model 4: wk/wv's 16 columns split 4 a rank (k and v gathered before
    the qk-norm and rope), and mlp/down's shards end inside a quant group
    (it runs whole on its gathered codes)."""
    got, want = gemma_model4
    modes = got[0][0]["modes"]
    assert modes["blocks.0.mlp.down"] == "whole"
    assert modes["blocks.0.attn.wk"] == modes["blocks.0.mlp.up"] == "col"
    assert modes["blocks.0.attn.wo"] == "row" and modes["head"] == "col"
    for rank in got:
        _check(rank[0]["steps"], want)


def test_llama_on_model2_aligned(refs):
    """Every linear splits whole groups and heads; each block is
    recomputed in the backward (remat), its collectives with it."""
    r = refs["llama7b-proxy"]
    cases = [("llama7b-proxy", r.tree, _batches(4, 4), {"remat": True})]
    got = run_ranks(rank_steps, 2, ((1, 2), ("data", "model"), cases, False),
                    deadline_s=DEADLINE)
    want = _ref_run(r, cases[0][2])
    assert set(got[0][0]["modes"].values()) == {"col", "row"}
    for rank in got:
        _check(rank[0]["steps"], want)


# reduced starcoder2-7b (2 KV heads, a plain GELU MLP) with other heads
HEADS = {"uneven": {"n_heads": 6, "head_dim": 32},
         "irregular": {"n_heads": 12, "n_kv_heads": 3}}


@pytest.fixture(scope="module")
def heads_model4(refs):
    ref = {k: _ref("starcoder2-7b", **over) for k, over in HEADS.items()}
    cases = [("starcoder2-7b", ref[k].tree, _batches(4, 9 + i), HEADS[k])
             for i, k in enumerate(HEADS)]
    got = run_ranks(rank_steps, 4, ((1, 4), ("data", "model"), cases,
                                    False), deadline_s=DEADLINE)
    return got, {k: _ref_run(ref[k], c[2]) for k, c in zip(HEADS, cases)}


def test_query_heads_that_model_does_not_divide(heads_model4):
    """6 query heads over model 4: every rank gathers q, k and v and
    computes every head's attention, and wo (192 rows, 12 groups of 16)
    is a row linear on this rank's slice of the output."""
    got, want = heads_model4
    modes = got[0][0]["modes"]
    assert modes["blocks.0.attn.wq"] == modes["blocks.0.attn.wk"] == "col"
    assert modes["blocks.0.attn.wo"] == "row"
    for rank in got:
        _check(rank[0]["steps"], want["uneven"])


def test_query_heads_that_group_unevenly_over_kv_heads(heads_model4):
    """12 query heads over 3 KV heads at model 4: rank 1's query heads
    3-5 read KV heads 0, 1, 1, no even grouping, so each takes the KV
    head of each of its query heads from the gathered k and v."""
    got, want = heads_model4
    modes = got[0][1]["modes"]
    assert modes["blocks.0.attn.wq"] == modes["blocks.0.attn.wk"] == "col"
    for rank in got:
        _check(rank[1]["steps"], want["irregular"])


# --- the merge, the sync, checkpoints ---------------------------------------


def test_merge_of_shards_equals_merge_of_gathered(gemma_model4):
    """Trained on model 4, merged: the merged shards gathered equal the
    gathered tree merged (codes and scales identical, zeros within 1e-6
    relative)."""

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif path.endswith("/zero"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=path)
    for rank in gemma_model4[0]:
        a, b = rank[0]["merged"]
        walk(a, b)
        assert a["blocks"]["attn"]["wq"]["scheme"] == "intq"


def _round_trip(x):
    """The reference's compressed_mean of two equal pods, in f32 numpy."""
    f32 = np.float32
    scale = f32(np.abs(x).max()) / f32(127.0)
    scale = f32(1.0) if scale <= 0 else scale
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32)
    return ((2 * q).astype(f32) * scale / f32(2)).astype(x.dtype)


def test_int8_sync_matches_reference_and_pods_agree(refs):
    import jax
    from repro.optim import compressed_mean as ref_mean
    rng = np.random.default_rng(6)
    values = {"a": rng.normal(size=(2, 6, 5)).astype(np.float32),
              "b": (rng.normal(size=(2, 3, 7)) * 1e-3).astype(np.float32),
              "z": np.zeros((2, 4), np.float32)}
    got = run_ranks(rank_sync, 4, ((2, 1, 2), ("pod", "data", "model"),
                                   values, refs["gemma3-1b"].tree,
                                   _batches(4, 7)),
                    deadline_s=DEADLINE)
    want = jax.vmap(lambda t: ref_mean(t, "pod"), axis_name="pod")(
        {k: jax.numpy.asarray(v) for k, v in values.items()})
    specs = rules.param_specs(
        TLM(TC.reduced("gemma3-1b")).init(torch.Generator(), "meta"),
        {"pod": 2, "data": 1, "model": 2})
    for rank, (mean, before, after, cli) in enumerate(got):
        pod = rank // 2
        for k in values:
            np.testing.assert_array_equal(mean[k], np.asarray(want[k])[pod])
        # after a global step the adapters are already equal over pods:
        # the sync is the int8 round trip of each rank's block (its scale
        # that block's absmax, as under the reference's shard_map), and
        # moves no element by more than its tensor's absmax / 254
        for k in before:
            blocks = [before[k]]
            spec = specs[k]
            for dim, axes in enumerate(spec):
                if axes == "model":
                    blocks = np.split(before[k], 2, axis=dim)
                    break
            rt = [_round_trip(b) for b in blocks]
            rt = np.concatenate(rt, axis=dim) if len(rt) > 1 else rt[0]
            np.testing.assert_array_equal(after[k], rt, err_msg=k)
            step = np.abs(after[k] - before[k]).max()
            assert step <= np.abs(before[k]).max() / 254 * (1 + 1e-6), k
        for k in after:
            np.testing.assert_array_equal(after[k], got[0][2][k])
            np.testing.assert_array_equal(cli[k], got[0][3][k])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    whole = str(tmp_path_factory.mktemp("mesh_whole"))
    cut = str(tmp_path_factory.mktemp("mesh_cut"))
    got = run_ranks(rank_checkpoints, 2, ((1, 2), ("data", "model"), whole,
                                          cut), deadline_s=DEADLINE)
    return SimpleNamespace(whole=whole, cut=cut, runs=got[0])


def test_resume_on_the_same_mesh_is_bit_identical(checkpoints):
    full, first, resumed = checkpoints.runs
    assert resumed["start"] == 2
    assert first["loss"] + resumed["loss"] == full["loss"]
    for key in ("t", "mu", "nu"):
        for k, v in full[key].items():
            np.testing.assert_array_equal(resumed[key][k], v, err_msg=k)


def test_elastic_restore_on_one_process_and_on_2x2(checkpoints):
    """Written on model 2; restored with no mesh and on data 2 x model 2,
    the gathered adapters and moments are bit-identical."""
    from repro_torch.checkpoint import load_pytree, step_path
    full = checkpoints.runs[0]
    one = load_pytree(step_path(checkpoints.whole, 4))
    got = run_ranks(rank_restore, 4, ((2, 2), ("data", "model"),
                                      checkpoints.whole),
                    deadline_s=DEADLINE)
    for k, v in full["t"].items():
        np.testing.assert_array_equal(one["t"][k].numpy(), v, err_msg=k)
        for rank in got:
            assert rank["start"] == 4
            np.testing.assert_array_equal(rank["t"][k], v, err_msg=k)
            np.testing.assert_array_equal(rank["mu"][k], full["mu"][k])
    meta = __import__("json").load(open(os.path.join(
        step_path(checkpoints.whole, 4), "manifest.json")))["meta"]
    assert meta["mesh"] == {"data": 1, "model": 2}
    args = ttrain.build_parser().parse_args(
        CLI + ["--arch", "llama7b-proxy", "--steps", "4", "--ckpt-dir",
               checkpoints.whole])
    st = ttrain.setup(args)  # one process, no mesh: restores, no refusal
    assert st.start == 4
    for k, v in full["t"].items():
        np.testing.assert_array_equal(st.trainable[k].detach().numpy(), v)


def test_resume_refuses_a_directory_that_some_rank_cannot_read(
        checkpoints, tmp_path):
    """Rank 0 finds step 4; the other rank's directory is empty (not a
    shared file system): both refuse, none restores or hangs."""
    got = run_ranks(rank_unshared, 2, ((1, 2), ("data", "model"),
                                       checkpoints.whole, str(tmp_path)),
                    deadline_s=DEADLINE)
    for msg in got:
        assert "1 of 2 ranks cannot read" in msg
        assert "every rank shares" in msg


# --- one process -------------------------------------------------------------


def test_mesh_cpu_with_sync_every_is_the_one_device_run():
    """--sync-every does nothing without a "pod" axis, as in
    ``repro.launch.train``; --mesh cpu is one device, its step
    make_train_fn."""
    base = ["--arch", "gemma3-1b", "--steps", "2"]
    a = _cli(make_cpu_mesh(), base)
    b = _cli(make_cpu_mesh(), base + ["--sync-every", "1"])
    assert a["loss"] == b["loss"]
    for k in a["t"]:
        np.testing.assert_array_equal(a["t"][k], b["t"][k])
    lm = TLM(TC.reduced("gemma3-1b"))
    assert S.make_train_step(lm, make_cpu_mesh()).__qualname__ == \
        S.make_train_fn(lm, AdamWConfig()).__qualname__
    assert S.make_sync_step(make_cpu_mesh()) is None


@pytest.mark.parametrize("mesh,want", (("pod", "256"), ("multipod", "512")))
def test_production_mesh_refuses_another_world_size(mesh, want, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--arch", "gemma3-1b", "--steps", "1", "--mesh",
                           mesh])
    err = capsys.readouterr().err
    assert f"wants {want} processes" in err and "got 1" in err


@pytest.mark.parametrize("flags", (["--arch", "mixtral-8x22b", "--mode",
                                    "lora"],
                                   ["--arch", "rwkv6-7b"],
                                   ["--arch", "gemma3-1b", "--mode", "lora"],
                                   ["--arch", "gemma3-1b", "--mode", "qlora"]))
def test_other_families_and_modes_are_refused_on_a_mesh(flags, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--steps", "1", "--mesh", "pod"] + flags)
    err = capsys.readouterr().err
    assert "not yet ported on a mesh" in err and "ROADMAP" in err


def test_check_mesh_support_refuses_a_policy_of_other_schemes():
    cfg = TC.reduced("gemma3-1b")
    S.check_mesh_support(cfg, {"qalora", "fp"})
    for used in ({"qalora", "lora"}, {"fp"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            S.check_mesh_support(cfg, used)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.check_mesh_support(TC.reduced("zamba2-7b"), {"qalora"})


def test_check_mesh_support_refuses_a_vocabulary_model_does_not_split():
    cfg = TC.reduced("gemma3-1b", vocab=250)
    S.check_mesh_support(cfg, {"qalora"}, SimpleNamespace(size=lambda a: 2))
    with pytest.raises(NotImplementedError, match="vocabulary 250.*ROADMAP"):
        S.check_mesh_support(cfg, {"qalora"},
                             SimpleNamespace(size=lambda a: 4))


def test_shard_and_gather_are_inverse_on_one_process():
    params = TLM(TC.reduced("gemma3-1b")).init(
        torch.Generator().manual_seed(0), "cpu")
    mesh = make_cpu_mesh()
    assert shard_params(params, mesh) is params
    assert gather_params(params, mesh) is params


def test_int8_compress_matches_reference():
    """``int8_compress`` / ``int8_decompress`` against the reference's, bit
    for bit, on a tensor and on zeros (scale 1)."""
    jnp = pytest.importorskip("jax").numpy
    from repro.optim.compression import int8_compress as ref_c
    from repro.optim.compression import int8_decompress as ref_d
    from repro_torch.optim import int8_compress, int8_decompress
    for x in (np.random.default_rng(8).normal(size=(5, 7)).astype(np.float32),
              np.zeros((3,), np.float32)):
        q, scale = int8_compress(torch.from_numpy(x))
        rq, rscale = ref_c(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(scale) == float(rscale)
        np.testing.assert_array_equal(int8_decompress(q, scale).numpy(),
                                      np.asarray(ref_d(rq, rscale)))
