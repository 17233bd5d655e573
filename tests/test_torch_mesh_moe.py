"""The MoE families on a mesh of CPU processes (gloo): the port's sharded
train step of reduced mixtral-8x22b in each of the three expert layouts
the reference's rule gives, and of reduced deepseek-v3-671b (MLA on
"model", sigmoid routing, a shared expert, a dense layer and the MTP
head) under full expert parallelism, against the reference's
single-device ``jax.jit(make_train_fn(...))``.

The layouts (``repro_torch.sharding.rules``, the reference's order):

* full expert parallelism: E = 4 over data 2 x model 2, one expert a rank
  (each block recomputed in the backward);
* experts over "model" alone: E = 6 (4 does not divide it, 2 does), three
  a rank, replicated over "data";
* tensor-parallel inside each expert: E = 3, each rank a block of every
  expert's capacity over "data", gate and up ``col``; down ``row`` on data
  2 x model 2, where its shard (moe_d_ff 32 over 2) ends on a quantization
  group boundary (groups of 16), ``whole`` on model 4, where it does not.

The batches are uneven: the first data rank's rows repeat one token (all
routed alike, so an expert overflows its capacity and later tokens of the
global order are dropped) with most labels masked, over two routing
chunks of 16 positions.  The bound is ``tests/test_torch_mesh_train.py``'s
(1e-5 of each tensor's largest magnitude, the AdamW allowance for the
adapters), the moments after the first step within
``LATER_MOMENTS_REL`` (``tests/test_torch_moe_train.py``'s).  The routing
the ranks record equals the reference's, read from its ``_route`` through
a debug callback, before any number is compared.  Two controls must fail:
a capacity computed from a rank's own tokens, and full-EP expert
gradients summed over "data" as a replicated leaf's would be.  The ranks
import this module, not JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.launch import steps as S
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import AdamWConfig, adamw_init, trainable_tensors
from repro_torch.perf.cost import tensor_bytes
from repro_torch.sharding import (gather_params, gather_tensors, holds_expert,
                                  param_specs, rank_param_bytes,
                                  shard_params, shard_tensor, shard_tensors,
                                  tp_of)
from test_torch_mesh_train import CLI, LR, SEQ, _cli

DEADLINE = 150.0
LATER_MOMENTS_REL = 1e-4  # tests/test_torch_moe_train.py's
# the layouts: (arch, config overrides, mesh sizes over data x model)
CASES = {
    "full_ep": ("mixtral-8x22b", {"remat": True}, (2, 2)),
    "ep_model": ("mixtral-8x22b", {"n_experts": 6}, (2, 2)),
    "mla": ("deepseek-v3-671b", {}, (2, 2)),
    "tp_row": ("mixtral-8x22b", {"n_experts": 3}, (2, 2)),
    "tp_whole": ("mixtral-8x22b", {"n_experts": 3}, (1, 4)),
}
# the reference run each case is held to (one model for both TP meshes)
REF = {"full_ep": "full_ep", "ep_model": "ep_model", "mla": "mla",
       "tp_row": "tp", "tp_whole": "tp"}
ROWS = 4


def _batches(seed):
    """Three [ROWS, SEQ] batches: the first data rank's two rows one
    repeated token with 70% of the labels masked (and a row with none),
    the other rank's random tokens with 10% masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        toks = rng.integers(4, 256, size=(ROWS, SEQ)).astype(np.int32)
        toks[:2] = rng.integers(4, 256)
        labs = rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32)
        labs[:2][rng.random((2, SEQ)) < 0.7] = -1
        labs[0] = -1
        labs[2:][rng.random((2, SEQ)) < 0.1] = -1
        out.append((toks, labs))
    return out


def _tb(toks, labs):
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}


# --- what the ranks run (module level: pickled by name) ---------------------


def _leaves(module):
    return {**dict(module.named_buffers()), **dict(module.named_parameters())}


def _layout(full, shard, mesh):
    """This rank's leaves against the rules: each an own-dims block of
    the full leaf under ``param_specs``, the experts held those
    ``holds_expert`` names, the bytes ``rank_param_bytes``; and shard and
    gather inverse (the params, and the adapters as ``name -> tensor``)."""
    specs = param_specs(full, mesh)
    mine, whole = _leaves(shard), _leaves(full)
    experts = shard.specs.experts
    want = {k for k in whole if k not in experts
            or holds_expert(mesh, *experts[k])}
    blocks = all(torch.equal(t, shard_tensor(whole[k], specs[k], mesh))
                 for k, t in mine.items())
    back = _leaves(gather_params(shard, mesh))
    tr = trainable_tensors(shard)
    again = shard_tensors(gather_tensors(tr, shard.specs, mesh),
                          shard.specs, mesh)
    held = sorted({e for n, m in shard.named_modules() if hasattr(m, "ep")
                   for e in m.ep.experts})
    return {"names_held": set(mine) == want, "blocks": blocks,
            "bytes": tensor_bytes(*mine.values())
            == rank_param_bytes(full, mesh),
            "gather_inverse": set(back) == set(whole) and all(
                torch.equal(back[k], whole[k]) for k in whole),
            "shard_inverse": list(again) == list(tr) and all(
                torch.equal(again[k], tr[k]) for k in tr),
            "experts": held,
            "modes": {n: tp_of(m).mode.value for n, m in shard.named_modules()
                      if tp_of(m) is not None}}


def _trajectory(mesh, arch, over, tree, batches, layout=True):
    """The sharded steps from ``tree``: per step the metrics, the gathered
    adapters and moments (the bridge's layout), the first step's routing
    as this rank recorded it, and (``layout``) :func:`_layout`."""
    cfg = TC.reduced(arch, **over)
    full = bridge.load_numpy_tree(tree, cfg, "cpu")
    shard = shard_params(full, mesh)
    lay = _layout(full, shard, mesh) if layout else None
    tr = trainable_tensors(shard)
    opt = adamw_init(tr)
    step = S.make_train_step(TLM(cfg), mesh, AdamWConfig(lr=LR))
    out, routes = [], None
    for toks, labs in batches:
        with tmoe.record_routing() as rec:
            m = step(shard, opt, _tb(toks, labs))
        if routes is None:
            routes = [(r["idx"].numpy(), r["keep"].numpy()) for r in rec]
        row = {k: float(m[k]) for k in ("loss", "xent", "aux", "grad_norm",
                                        "lr")}
        for key, vals in (("adapters", tr), ("mu", opt["mu"]),
                          ("nu", opt["nu"])):
            # copies: a replicated leaf gathers as the very tensor, which
            # the next step updates in place
            row[key] = bridge.adapters_numpy(full, {
                k: v.clone() for k, v in gather_tensors(
                    vals, shard.specs, mesh).items()})
        row["step"] = int(opt["step"])
        out.append(row)
    return {"steps": out, "routes": routes, "layout": lay}


def _per_rank_capacity(n):
    """A control: each rank's capacity from its own tokens alone."""
    real = tmoe._capacity
    return lambda k, tokens, e, cf: real(k, tokens // n, e, cf)


def _experts_over_data(real):
    """A control: every gradient summed over "data", a full-EP expert's
    too (as a replicated leaf's)."""
    def axes(params, dp):
        return {k: tuple(dict.fromkeys(dp + v)) if k in params.specs.experts
                else v for k, v in real(params, dp).items()}
    return axes


def rank_moe(rank, sizes, cases, controls, ckpt=None):
    """Each case (name, arch, overrides, tree, batches) trained on the
    mesh; with ``controls`` one step of the first case under each
    control; with ``ckpt`` (whole, cut) reduced mixtral's CLI run of 4
    steps, and one cut at step 2 and resumed."""
    mesh = make_mesh(sizes, ("data", "model"))
    out = {name: _trajectory(mesh, arch, over, tree, batches)
           for name, arch, over, tree, batches in cases}
    if controls:
        name, arch, over, tree, batches = cases[0]
        real_cap, real_axes = tmoe._capacity, S.grad_sum_axes
        for ctl, patch in (("per_rank_capacity",
                            lambda: setattr(tmoe, "_capacity",
                                            _per_rank_capacity(sizes[0]))),
                           ("experts_over_data",
                            lambda: setattr(S, "grad_sum_axes",
                                            _experts_over_data(real_axes)))):
            patch()
            try:
                out[ctl] = _trajectory(mesh, arch, over, tree, batches[:1],
                                       layout=False)["steps"]
            finally:
                tmoe._capacity, S.grad_sum_axes = real_cap, real_axes
    if ckpt:
        whole, cut = ckpt
        base = ["--arch", "mixtral-8x22b", "--mesh", "pod"]
        out["cli"] = (_cli(mesh, base + ["--steps", "4", "--ckpt-dir", whole]),
                      _cli(mesh, base + ["--steps", "2", "--ckpt-dir", cut]),
                      _cli(mesh, base + ["--steps", "4", "--ckpt-dir", cut]))
    return out


# --- the reference's side ----------------------------------------------------


def _ref(arch, over):
    """The reference's params (``jax.jit`` of its ``LM.init``, adapters
    nudged) and their numpy tree."""
    import jax
    from _torch_parity import bump, numpy_tree
    import repro.configs as RC
    from repro.models.lm import LM as RLM
    lm = RLM(RC.reduced(arch, **over))
    params = bump(jax.jit(lm.init)(jax.random.PRNGKey(0)))
    return SimpleNamespace(lm=lm, params=params, tree=numpy_tree(params))


def _ref_run(ref, batches, spied):
    """The reference's single-device steps (``jax.jit(make_train_fn)``):
    per step its metrics, adapters and moments, and the first step's
    expert ids of every routing group in call order (layer, then chunk),
    from its ``_route`` (``spied``: the module's real one, wrapped here
    with an ordered debug callback while the step is traced)."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import ref_adapters
    import repro.models.moe as RM
    from repro.launch.steps import make_train_fn
    from repro.optim import AdamWConfig as RAdamW
    from repro.optim import adamw_init as ref_adamw_init
    from repro.optim import split_params
    ids = []

    def spy(*args, **kw):
        gates, idx, aux = spied(*args, **kw)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), idx,
                           ordered=True)
        return gates, idx, aux
    step = jax.jit(make_train_fn(ref.lm, RAdamW(lr=LR)))
    tr, fr = split_params(ref.params)
    opt = ref_adamw_init(tr)
    out = []
    for i, (toks, labs) in enumerate(batches):
        RM._route = spy if i == 0 else spied  # traced at the first call
        try:
            tr, opt, m = step(tr, fr, opt, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labs)})
            jax.effects_barrier()
        finally:
            RM._route = spied
        out.append({**{k: float(m[k]) for k in ("loss", "xent", "aux",
                                                "grad_norm", "lr")},
                    "adapters": ref_adapters(tr), "mu": ref_adapters(
                        opt["mu"]), "nu": ref_adapters(opt["nu"]),
                    "step": int(opt["step"])})
        if i == 0:
            routing = list(ids)
    return out, routing


def _close(got, want, where, rel=1e-5, allow=None):
    from test_torch_train import _close as close
    close(got, want, rel=rel, where=where, allow=allow)


def _check(got, want):
    """Every step's metrics within 1e-5 (aux too); the moments within
    1e-5 after step 1 and ``LATER_MOMENTS_REL`` after; the adapters
    after steps 1 and 3 within 1e-5 plus the AdamW allowance."""
    from test_torch_train import _adam_allowance
    cfg = AdamWConfig(lr=LR)
    moments = []
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            _close(np.float64(g[k]), np.float64(w[k]), f"{i}/{k}")
        assert g["step"] == w["step"] == i + 1
        rel = 1e-5 if i == 0 else LATER_MOMENTS_REL
        _close(g["mu"], w["mu"], f"{i}/mu", rel)
        _close(g["nu"], w["nu"], f"{i}/nu", rel)
        moments.append(((g["mu"], g["nu"]), (w["mu"], w["nu"])))
        if i in (0, 2):
            _close(g["adapters"], w["adapters"], f"{i}/adapters",
                   allow=_adam_allowance(moments, cfg))


def _global_routes(ranks, name, sizes):
    """Each MoE call's recorded (ids, kept) [B, S, k] of the global
    batch: the data ranks' rows in order (model rank 0 of each)."""
    per = [ranks[d * sizes[1]][name]["routes"] for d in range(sizes[0])]
    return [tuple(np.concatenate([p[i][j] for p in per]) for j in (0, 1))
            for i in range(len(per[0]))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its mesh (one spawn of data 2 x model 2 with the
    controls and the checkpoint runs, one of model 4), and meanwhile, in
    a thread of this process, the reference's steps and routing of
    each."""
    import threading
    pytest.importorskip("jax")
    import repro.models.moe as RM
    models = {REF[n]: (a, o) for n, (a, o, _) in CASES.items()}
    refs = {k: _ref(a, o) for k, (a, o) in models.items()}
    data = {k: _batches(i) for i, k in enumerate(models)}
    want, errors = {}, []

    def reference():
        try:
            for k in models:
                want[k] = _ref_run(refs[k], data[k], RM._route)
        except BaseException as e:  # raised in the fixture below
            errors.append(e)
    thread = threading.Thread(target=reference, daemon=True)
    thread.start()
    whole = str(tmp_path_factory.mktemp("moe_whole"))
    cut = str(tmp_path_factory.mktemp("moe_cut"))
    got = {}
    try:
        for sizes in ((2, 2), (1, 4)):
            cases = [(n, a, o, refs[REF[n]].tree, data[REF[n]])
                     for n, (a, o, sz) in CASES.items() if sz == sizes]
            two = sizes == (2, 2)
            ranks = run_ranks(rank_moe, sizes[0] * sizes[1], (
                sizes, cases, two, (whole, cut) if two else None),
                deadline_s=DEADLINE)
            for n, *_ in cases:
                got[n] = SimpleNamespace(
                    ranks=[r[n] for r in ranks],
                    routes=_global_routes(ranks, n, sizes))
            if two:
                got["controls"] = {k: ranks[0][k] for k in (
                    "per_rank_capacity", "experts_over_data")}
                got["cli"] = [r["cli"] for r in ranks]
    finally:
        thread.join(DEADLINE)
    if errors:
        raise errors[0]
    assert not thread.is_alive(), "the reference's runs did not finish"
    return SimpleNamespace(
        got=got, whole=whole,
        want={n: want[REF[n]][0] for n in CASES},
        routing={n: want[REF[n]][1] for n in CASES})


def _routing_equal(got_routes, ref_ids, cfg):
    """The recorded ids equal the reference's group by group, the kept
    mask its positions under the global capacity; returns the drops."""
    import jax.numpy as jnp
    import repro.models.moe as RM
    chunk = cfg.moe_chunk
    groups = [(idx[:, c:c + chunk], keep[:, c:c + chunk])
              for idx, keep in got_routes
              for c in range(0, idx.shape[1], chunk)]
    # a rematerialised step routes again in its backward, after the forward
    assert len(ref_ids) in (len(groups), 2 * len(groups))
    dropped = 0
    for (idx, keep), ridx in zip(groups, ref_ids):
        k = idx.shape[-1]
        np.testing.assert_array_equal(idx.reshape(-1, k), ridx)
        pos = np.asarray(RM._positions_in_expert(
            jnp.asarray(ridx.reshape(-1)), cfg.n_experts))
        cap = tmoe._capacity(k, ridx.shape[0], cfg.n_experts,
                             cfg.capacity_factor)
        np.testing.assert_array_equal(keep.reshape(-1), pos < cap)
        dropped += int((pos >= cap).sum())
    return dropped


@pytest.mark.parametrize("name", list(CASES))
def test_layout_step_and_routing_match_reference(runs, name):
    """The routing the ranks record equals the reference's (every group's
    ids, the kept set of the global capacity, drops included); then every
    rank's three steps (loss, xent, aux, grad norm, moments, adapters)
    are the reference's within the bound, and each rank holds the
    layout's leaves."""
    arch, over, sizes = CASES[name]
    got = runs.got[name]
    cfg = TC.reduced(arch, **over)
    dropped = _routing_equal(got.routes, runs.routing[name], cfg)
    assert dropped > 0, name
    for rank in got.ranks:
        _check(rank["steps"], runs.want[name])
        lay = rank["layout"]
        assert all(lay[k] for k in ("names_held", "blocks", "bytes",
                                    "gather_inverse", "shard_inverse")), lay
    experts = [r["layout"]["experts"] for r in got.ranks]
    modes = got.ranks[0]["layout"]["modes"]
    moe = "moe_blocks.0.moe" if arch == "deepseek-v3-671b" else "blocks.0.moe"
    if name in ("full_ep", "mla"):
        assert experts == [[0], [1], [2], [3]]
        assert modes[f"{moe}.up.0"] == "whole"
    elif name == "ep_model":
        assert experts == [[0, 1, 2], [3, 4, 5]] * 2
    else:
        assert experts == [[0, 1, 2]] * 4
        assert modes[f"{moe}.up.0"] == modes[f"{moe}.gate.0"] == "col"
        assert modes[f"{moe}.down.0"] == ("row" if name == "tp_row"
                                          else "whole")


def test_mla_shards_heads_and_gathers_its_latents(runs):
    """deepseek-v3's MLA: q_down and kv_down ``col`` (their latents
    gathered for the norms), q_up and kv_up ``col`` over this rank's
    heads, wo ``row``, the router ``col`` (E = 4 over model 2), the MTP
    projection ``col``; the loss carries the MTP term."""
    modes = runs.got["mla"].ranks[0]["layout"]["modes"]
    attn = "moe_blocks.0.attn"
    for n in ("q_down", "q_up", "kv_down", "kv_up"):
        assert modes[f"{attn}.{n}"] == "col", n
    assert modes[f"{attn}.wo"] == "row"
    assert modes["moe_blocks.0.moe.router"] == "col"
    assert modes["mtp_proj"] == "col"
    assert modes["mtp_block.attn.q_up"] == "col"
    step = runs.want["mla"][0]
    coef = TC.reduced("deepseek-v3-671b").aux_coef
    assert step["loss"] > step["xent"] + coef * step["aux"]


@pytest.mark.parametrize("control", ("per_rank_capacity",
                                     "experts_over_data"))
def test_control_fails(runs, control):
    """A capacity from a rank's own tokens (it drops other tokens), and
    full-EP expert gradients summed over "data": each misses the
    reference's first step."""
    (ctl,) = runs.got["controls"][control]
    want = runs.want["full_ep"][0]
    with pytest.raises(AssertionError):
        _close(ctl["mu"], want["mu"], "control/mu")


def test_checkpoint_resumes_on_the_mesh_and_restores_on_one_process(runs):
    """Reduced mixtral's CLI on data 2 x model 2 (full EP): cut at step 2
    and resumed, bit for bit the uninterrupted run's; its step-4
    checkpoint restored on one process equals the gathered adapters."""
    for full, first, resumed in runs.got["cli"]:
        assert resumed["start"] == 2
        assert first["loss"] + resumed["loss"] == full["loss"]
        for key in ("t", "mu", "nu"):
            assert set(resumed[key]) == set(full[key])
            for k, v in full[key].items():
                np.testing.assert_array_equal(resumed[key][k], v, err_msg=k)
    full = runs.got["cli"][0][0]
    assert any(".moe.up.3." in k for k in full["t"])
    args = ttrain.build_parser().parse_args(
        CLI + ["--arch", "mixtral-8x22b", "--steps", "4", "--ckpt-dir",
               runs.whole])
    st = ttrain.setup(args)
    assert st.start == 4
    assert set(st.trainable) == set(full["t"])
    for k, v in full["t"].items():
        np.testing.assert_array_equal(st.trainable[k].detach().numpy(), v,
                                      err_msg=k)


# --- one process -------------------------------------------------------------


def test_cli_refuses_before_it_builds_the_mesh(capsys):
    """One process, ``--mesh pod --arch rwkv6-7b``: the family's refusal,
    not the world size's."""
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--steps", "1", "--mesh", "pod", "--arch",
                           "rwkv6-7b"])
    err = capsys.readouterr().err
    assert S.MESH_NOT_PORTED in err and "wants 256 processes" not in err


@pytest.mark.parametrize("arch", ("mixtral-8x22b", "deepseek-v3-671b"))
def test_moe_families_pass_to_the_world_size_check(arch, capsys):
    """Admitted in --mode qalora, a one-process ``--mesh pod`` run stops
    at the world size, as a gqa one does."""
    with pytest.raises(SystemExit):
        ttrain.main(CLI + ["--steps", "1", "--mesh", "pod", "--arch", arch])
    err = capsys.readouterr().err
    assert "wants 256 processes" in err and "got 1" in err


def test_sync_over_pod_keeps_experts_that_pod_does_not_split():
    """deepseek-v3 on the multipod mesh splits its 256 experts over
    "model" alone (256 does not divide 2 x 16 x 16): every expert is
    replicated over "pod", so the int8 sync averages each with its own
    copies; an expert leaf split over "pod" is refused."""
    from repro_torch.sharding import ShardSpecs, expert_split
    cfg = TC.get("deepseek-v3-671b")
    r, d, f = cfg.quant.default.rank, cfg.d_model, cfg.moe_d_ff
    leaves = {f"moe_blocks.0.moe.{k}.{e}.ad.{a}": shape
              for e in range(cfg.n_experts)
              for k, (n_in, n_out) in (("up", (d, f)), ("down", (f, d)))
              for a, shape in (("a", (n_in // cfg.quant.default.group_size,
                                      r)), ("b", (r, n_out)))}
    shape = {"pod": 2, "data": 16, "model": 16}
    split = expert_split(leaves, shape)
    assert len(split) == len(leaves)
    assert split and {axes for axes, _, _ in split.values()} == {("model",)}
    pods = SimpleNamespace(shape={"pod": 2, "model": 1})
    assert S.make_sync_step(pods, ShardSpecs({}, split)) is not None
    bad = ShardSpecs({}, {"x.0.a": (("pod", "model"), 0, 4)})
    with pytest.raises(ValueError, match="different experts"):
        S.make_sync_step(pods, bad)
