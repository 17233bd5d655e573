"""Decode on a mesh of CPU processes (gloo), the program the dry run
(``repro_torch.launch.dryrun``) counts for a decode cell, against the JAX
package's ``LM.decode_step`` and ``LM.generate`` run without a mesh.

The reference's params (``LM.init``, adapters nudged by +0.01), its
prefilled cache and its prefill logits go to every rank as numpy; each
rank carries the params across with ``repro_torch.bridge.load_numpy_tree``,
holds its shard (``shard_params``) and its part of the cache
(``sharding.cache_part`` under ``cache_spec_tree``), and runs
``steps.make_decode_step``'s step once and ``make_generate_step``'s
generation from the same prefilled cache.  The step's logits (each rank's
rows and vocabulary block, put together) are held to the reference's
within 1e-5 of the largest magnitude (f32), the greedy tokens must be
identical, and each rank's cache after the step and after the generation
must equal its part of the reference's under the reference's own
``cache_spec_tree`` (over an ``AbstractMesh`` of the same shape) within
that bound.

The cases, by the layout the reference's cache spec gives a rank:

* reduced llama7b-proxy (4 query heads, 2 KV heads of 16) on model 2:
  whole KV heads over "model" (the tensor-parallel attention's own);
* the same on model 4: 2 KV heads do not split over 4, the head_dim does
  (4 a rank): q, k and v gathered whole for the rope, each rank's
  head_dim block written and read, the partial scores summed over
  "model";
* reduced gemma3-1b (qk-norm, a local window of 8 and a global layer) on
  model 2: its one KV head's head_dim split, the adapter model and the
  merged one (merged on the shards, against the reference's
  ``merge_tree``);
* batch 1 on data 2 x model 1 and on data 2 x model 2: the rows do not
  split, the positions do (8 of 16 a rank): the prompt of 6 tokens and
  10 generated put a token on the ranks' boundary (position 8) and the
  local layer's window wholly on the second rank by the last step.

The ranks import this module, not JAX: JAX is imported inside the
functions that run the reference.  ``tests/test_torch_mesh_moe_decode.py``
reuses these helpers for the MoE families."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.core.schemes import merge_tree
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.lm import LM as TLM
from repro_torch.sharding import (cache_part, check_cache_part,
                                  decode_layout, gather_cache, shard_params)

TOL = 1e-5
DEADLINE = 200.0
NAMES = ("data", "model")
# name: (arch, config overrides, batch, prompt, capacity, generated[,
# merged])
CASES = {
    "llama_model2": ("llama7b-proxy", {}, 2, 8, 12, 4),
    "llama_model4": ("llama7b-proxy", {}, 2, 8, 12, 4),
    "gemma_model2": ("gemma3-1b", {}, 2, 8, 12, 4),
    "gemma_model2_merged": ("gemma3-1b", {}, 2, 8, 12, 4, True),
    "gemma_seq_data2": ("gemma3-1b", {}, 1, 6, 16, 11),
    "gemma_seq_data2_model2": ("gemma3-1b", {}, 1, 6, 16, 11),
}
SIZES = {"llama_model2": (1, 2), "llama_model4": (1, 4),
         "gemma_model2": (1, 2), "gemma_model2_merged": (1, 2),
         "gemma_seq_data2": (2, 1), "gemma_seq_data2_model2": (2, 2)}


# --- the reference's side ----------------------------------------------------


def reference(arch, over, b, prompt, cap, gen_len, merged=False):
    """The reference's params (numpy tree; ``merged``: through its
    ``merge_tree``), its prefilled cache (numpy), prefill logits, one
    decode step's logits and cache, and ``generate``'s tokens and cache,
    all without a mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.configs as RC
    from repro.core.schemes import merge_tree
    from repro.models.lm import LM as RLM
    from _torch_parity import bump, numpy_tree
    rlm = RLM(RC.reduced(arch, **over))
    params = adapters = bump(jax.jit(rlm.init)(jax.random.PRNGKey(0)))
    if merged:
        params = merge_tree(params)
    toks = (jnp.arange(b * prompt, dtype=jnp.int32).reshape(b, prompt)
            * 7 + 3) % rlm.cfg.vocab
    logits, pre = jax.jit(rlm.prefill)(params, {"tokens": toks})
    cache = rlm.merge_prefill_cache(
        pre, rlm.init_cache(b, cap, dtype=jnp.float32))
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    step, after = jax.jit(rlm.decode_step)(params, cache, nxt)
    gen, gen_cache = jax.jit(rlm.generate, static_argnums=3)(
        params, cache, logits, gen_len)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        arch=arch, over=over, tree=numpy_tree(params), cache=as_np(cache),
        logits=np.asarray(logits), nxt=np.asarray(nxt),
        step=np.asarray(step), after=as_np(after), gen=np.asarray(gen),
        gen_cache=as_np(gen_cache), gen_len=gen_len, merged=merged,
        adapter_tree=numpy_tree(adapters) if merged else None)


def ref_specs(cache, sizes):
    """The reference's ``cache_spec_tree`` of ``cache`` over an
    ``AbstractMesh`` of ``sizes`` over ("data", "model"): ``{leaf path:
    spec tuple}``."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.sharding import cache_spec_tree
    try:
        mesh = AbstractMesh(sizes, NAMES)
    except TypeError:
        mesh = AbstractMesh(tuple(zip(NAMES, sizes)))
    specs = cache_spec_tree(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), cache), mesh)
    out = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], path + (k,))
        else:
            out[path] = tuple(spec)
    walk(cache, specs, ())
    return out


def ref_part(x, spec, sizes, rank):
    """Rank ``rank``'s block of the reference's leaf ``x`` under its spec
    (row-major over each entry's axes, as the reference's mesh lays
    devices out)."""
    coords = dict(zip(NAMES, (rank // sizes[1], rank % sizes[1])))
    shape = dict(zip(NAMES, sizes))
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        n = i = 1
        i = 0
        for a in axes:
            i = i * shape[a] + coords[a]
            n *= shape[a]
        size = x.shape[dim] // n
        x = np.take(x, np.arange(i * size, (i + 1) * size), axis=dim)
    return x


# --- the ranks' side ---------------------------------------------------------


def _torch_cache(tree):
    if isinstance(tree, dict):
        return {k: _torch_cache(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree.numpy() if isinstance(tree, torch.Tensor) else tree}


def _rows(layout, mesh, b):
    """This rank's first row and row count of ``b``."""
    n = b // mesh.size(layout.rows)
    return mesh.index(layout.rows) * n, n


def run_case(mesh, ref):
    """One case on this rank: the decode step's logits and cache, the
    generation's tokens and cache, and the gathered cache equal to the
    full one the part came from."""
    cfg = TC.reduced(ref.arch, **ref.over)
    lm = TLM(cfg)
    full = _torch_cache(ref.cache)
    if ref.merged:  # the adapter model's shard merged, as served
        params = bridge.load_numpy_tree(ref.adapter_tree, cfg, "cpu")
        shard = merge_tree(shard_params(params, mesh))
        params = merge_tree(params)
    else:
        params = bridge.load_numpy_tree(ref.tree, cfg, "cpu")
        shard = shard_params(params, mesh)
    layout = decode_layout(full, mesh)
    first, n = _rows(layout, mesh, ref.nxt.shape[0])
    step, _ = S.make_decode_step(lm, mesh)(full)
    part = cache_part(full, mesh)
    gathered = gather_cache(part, full, mesh)
    logits, after = step(shard, part, torch.from_numpy(
        ref.nxt[first:first + n]))
    gen, _ = S.make_generate_step(lm, mesh, ref.gen_len, params)(full)
    toks, gen_part = gen(shard, cache_part(full, mesh),
                         torch.from_numpy(ref.logits[first:first + n]))
    return {"rows": (first, n), "logits": logits.numpy(),
            "after": _leaves(after), "tokens": toks.numpy(),
            "gen_part": _leaves(gen_part),
            "gathered_equal": all(torch.equal(a, b) for a, b in zip(
                _leaves_t(gathered), _leaves_t(full))),
            "layout": (layout.rows, layout.seq or (),
                       layout.heads is not None, layout.feature is not None)}


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves_t(tree[k])]
    return [tree]


def rank_cases(rank, sizes, refs, control=None):
    """Every case of ``refs`` ({name: reference}) on this rank; with
    ``control`` (a name of :data:`CONTROLS`), under it."""
    from repro_torch.models import attention
    mesh = make_mesh(sizes, NAMES)
    real = {k: getattr(attention, k) for k in ("_score_sum", "_seq_softmax")}
    if control:
        setattr(attention, *CONTROLS[control])
    try:
        return {name: run_case(mesh, ref) for name, ref in refs.items()}
    finally:
        for k, v in real.items():
            setattr(attention, k, v)


def _per_rank_softmax(scores, contract, layout):
    """The control of the sequence split: each rank's softmax normalised
    over its own positions, the ranks' contexts averaged."""
    mesh = layout.mesh
    o = contract(torch.softmax(scores, dim=-1))
    return mesh.all_reduce(o, layout.seq) / mesh.size(layout.seq)


# controls that must fail: (attention's function, its replacement)
CONTROLS = {"no_score_sum": ("_score_sum", lambda scores, mesh: scores),
            "per_rank_softmax": ("_seq_softmax", _per_rank_softmax)}


# --- the checks --------------------------------------------------------------


def _close(got, want, where=""):
    np.testing.assert_allclose(got, want, rtol=0, err_msg=where,
                               atol=TOL * max(np.abs(want).max(), 1e-30))


def assembled_logits(got, sizes):
    """The ranks' logits blocks put together: rows over data (where they
    split), vocabulary over "model"."""
    rows = {}
    for r, g in enumerate(got):
        rows.setdefault(g["rows"], {}).setdefault(r % sizes[1], g["logits"])
    return np.concatenate([np.concatenate([blocks[m] for m in sorted(blocks)],
                                          axis=-1)
                           for _, blocks in sorted(rows.items())])


def check_case(got, ref, sizes, name):
    """The step's logits, each rank's cache parts and the tokens against
    the reference (module docstring)."""
    _close(assembled_logits(got, sizes), ref.step, f"{name} logits")
    for which, want_cache in (("after", ref.after),
                              ("gen_part", ref.gen_cache)):
        specs = ref_specs(want_cache, sizes)
        for r, g in enumerate(got):
            for path, spec in specs.items():
                want = want_cache
                for k in path:
                    want = want[k]
                if path == ("len",):
                    first, n = g["rows"]
                    np.testing.assert_array_equal(g[which][path],
                                                  want[first:first + n])
                    continue
                part = ref_part(want, spec, sizes, r)
                assert g[which][path].shape == part.shape, (name, path)
                _close(g[which][path], part, f"{name} rank {r} {which} "
                                             f"{'/'.join(path)}")
    for g in got:
        first, n = g["rows"]
        np.testing.assert_array_equal(g["tokens"], ref.gen[first:first + n])
        assert g["gathered_equal"], name


@pytest.fixture(scope="module")
def runs():
    """Every case on its mesh (one spawn a mesh shape), and the controls
    on the head_dim split and the sequence split."""
    refs = {name: reference(*CASES[name]) for name in CASES}
    out = {}
    for sizes in sorted(set(SIZES.values())):
        names = [n for n in CASES if SIZES[n] == sizes]
        got = run_ranks(rank_cases, sizes[0] * sizes[1],
                        (sizes, {n: refs[n] for n in names}),
                        deadline_s=DEADLINE)
        out.update({n: [g[n] for g in got] for n in names})
    for control, name in (("no_score_sum", "llama_model4"),
                          ("per_rank_softmax", "gemma_seq_data2")):
        sizes = SIZES[name]
        got = run_ranks(rank_cases, sizes[0] * sizes[1],
                        (sizes, {name: refs[name]}, control),
                        deadline_s=DEADLINE)
        out[control] = [g[name] for g in got]
    return refs, out


@pytest.mark.parametrize("name", list(CASES))
def test_decode_and_generate_equal_reference(runs, name):
    refs, out = runs
    check_case(out[name], refs[name], SIZES[name], name)


@pytest.mark.parametrize("name,layout", (
    ("llama_model2", ((), (), True, False)),
    ("llama_model4", ((), (), False, True)),
    ("gemma_model2", ((), (), False, True)),
    ("gemma_seq_data2", ((), ("data",), False, False)),
    ("gemma_seq_data2_model2", ((), ("data",), False, True))))
def test_layout_the_cache_spec_gives(runs, name, layout):
    """Each case runs the layout its docstring names: (rows, positions,
    KV heads, head_dim) split."""
    _, out = runs
    assert all(tuple(g["layout"]) == layout for g in out[name])


@pytest.mark.parametrize("control,name", (("no_score_sum", "llama_model4"),
                                          ("per_rank_softmax",
                                           "gemma_seq_data2")))
def test_control_fails(runs, control, name):
    """The head_dim split without the partial scores' sum over "model",
    and the sequence split normalised per rank, miss the bound."""
    refs, out = runs
    got = assembled_logits(out[control], SIZES[name])
    assert np.abs(got - refs[name].step).max() > \
        TOL * np.abs(refs[name].step).max()


def test_a_drifted_cache_part_is_refused():
    """A rank's cache whose leaves are not the spec's parts (here the
    whole cache on model 4, where the spec splits head_dim) is refused
    before any step runs; so is a shard's step without its layout."""
    cfg = TC.reduced("llama7b-proxy")
    lm = TLM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), "cpu")
    cache = lm.init_cache(2, 12, dtype=torch.float32, device="cpu")
    with dryrun.fake_mesh((1, 4), NAMES, rank=1) as mesh:
        shard = shard_params(params, mesh)
        part = cache_part(cache, mesh)
        assert tuple(part["layers"]["k"].shape) == (2, 2, 12, 2, 4)
        check_cache_part(part, cache, mesh)
        step, _ = S.make_decode_step(lm, mesh)(cache)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="cache_spec_tree") as e:
            step(shard, cache, tok)
        assert "(2, 2, 12, 2, 16)" in str(e.value)
        assert "(2, 2, 12, 2, 4)" in str(e.value)
        with pytest.raises(ValueError, match="DecodeLayout"):
            lm.decode_step(shard, part, tok)
