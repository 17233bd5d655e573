"""The port's AdamW (``repro_torch.optim``) against the reference's
``adamw_update``, on a random tree of adapters, and the trainable/frozen
partition of a params module.

Five steps from the same values and gradients: parameters, moments, the
step counter and the ``grad_norm`` / ``lr`` metrics agree within 1e-6 of
each tensor's largest magnitude, for every schedule, with and without
weight decay, with the clip active and inactive, and with a zero
gradient (``n = 0``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.optim import AdamWConfig as RAdamW
from repro.optim import adamw_init as r_init
from repro.optim import adamw_update as r_update
from repro.optim import clip_by_global_norm as r_clip
from repro_torch.core import schemes
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, count_params, global_norm,
                               split_params, trainable_tensors)

REL = 1e-6
SHAPES = {"blocks.0.attn.wq.ad.a": (8, 4), "blocks.0.attn.wq.ad.b": (4, 24),
          "blocks.1.mlp.down.ad.a": (12, 4), "blocks.1.mlp.down.ad.b": (4, 16)}


def _close(got, ref, rel=REL, where=""):
    got = got.detach().cpu().double().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, where
    bound = rel * max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= bound, \
        f"{where}: {np.abs(got - ref).max():.3e} > {bound:.3e}"


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


CASES = {
    "constant": dict(),
    "constant_decay": dict(weight_decay=0.1),
    "cosine": dict(schedule="cosine", total_steps=8),
    "cosine_decay_no_clip": dict(schedule="cosine", total_steps=4,
                                 weight_decay=0.05, max_grad_norm=0.0),
    "warmup_cosine": dict(schedule="warmup_cosine", total_steps=6,
                          warmup_steps=3),
    "clip_inactive": dict(max_grad_norm=1e3),
    "clip_active": dict(max_grad_norm=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_matches_reference_over_five_steps(case):
    kw = dict(lr=3e-3, **CASES[case])
    rng = np.random.default_rng(sorted(CASES).index(case))
    p0 = _tree(rng)
    grads = [_tree(rng, scale=0.3) for _ in range(5)]
    if case == "clip_inactive":
        grads[2] = {k: np.zeros_like(v) for k, v in grads[2].items()}
    r_p = {k: jnp.asarray(v) for k, v in p0.items()}
    r_state = r_init(r_p)
    t_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    t_state = adamw_init(t_p)
    for i, g in enumerate(grads):
        r_p, r_state, r_m = r_update(RAdamW(**kw), {k: jnp.asarray(v) for
                                                    k, v in g.items()},
                                     r_state, r_p)
        t_m = adamw_update(AdamWConfig(**kw),
                           {k: torch.from_numpy(v) for k, v in g.items()},
                           t_state, t_p)
        for name in ("grad_norm", "lr"):
            _close(t_m[name], r_m[name], where=f"step {i} {name}")
        for k in SHAPES:
            _close(t_p[k], r_p[k], where=f"step {i} param {k}")
            _close(t_state["mu"][k], r_state["mu"][k], where=f"mu {k}")
            _close(t_state["nu"][k], r_state["nu"][k], where=f"nu {k}")
        assert int(t_state["step"]) == int(r_state["step"]) == i + 1


def test_zero_gradient_norm_is_zero_and_moves_nothing():
    """n = 0: the clip's max(n, 1e-9) keeps the scale finite; Adam's update
    is 0 / (0 + eps) = 0 with no weight decay."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    t_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = adamw_init(t_p)
    zeros = {k: torch.zeros_like(v) for k, v in t_p.items()}
    m = adamw_update(AdamWConfig(lr=1e-2), zeros, state, t_p)
    r_p = {k: jnp.asarray(v) for k, v in p0.items()}
    r_p2, _, r_m = r_update(RAdamW(lr=1e-2), jax.tree.map(jnp.zeros_like, r_p),
                            r_init(r_p), r_p)
    assert float(m["grad_norm"]) == float(r_m["grad_norm"]) == 0.0
    for k in SHAPES:
        assert torch.equal(t_p[k], torch.from_numpy(p0[k]))
        np.testing.assert_array_equal(np.asarray(r_p2[k]), p0[k])


@pytest.mark.parametrize("max_norm", (0.3, 100.0))
def test_clip_matches_reference_and_not_clip_grad_norm(max_norm):
    """The scale is min(1, max_norm / max(n, 1e-9)), not
    ``clip_grad_norm_``'s max_norm / (n + 1e-6)."""
    g = _tree(np.random.default_rng(1))
    t_clip, t_n = clip_by_global_norm({k: torch.from_numpy(v) for k, v in
                                       g.items()}, max_norm)
    r_clipped, r_n = r_clip({k: jnp.asarray(v) for k, v in g.items()},
                            max_norm)
    _close(t_n, r_n)
    for k in g:
        _close(t_clip[k], r_clipped[k], where=k)
    n = float(t_n)
    assert float(global_norm(t_clip)) == pytest.approx(min(n, max_norm),
                                                       rel=1e-6)


def test_bf16_parameters_keep_f32_moments_and_stay_in_place():
    """Moments are f32 whatever the parameter's dtype; the update is made
    in f32 and cast to bf16; every parameter keeps its storage and stays
    contiguous (the kernels read adapters through raw pointers)."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    t_p = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    ptrs = {k: v.data_ptr() for k, v in t_p.items()}
    state = adamw_init(t_p)
    assert all(v.dtype == torch.float32 for v in state["mu"].values())
    g = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _tree(rng, 0.3).items()}
    ref = {k: v.clone() for k, v in t_p.items()}
    adamw_update(AdamWConfig(lr=1e-2), g, state, t_p)
    for k, v in t_p.items():
        assert v.dtype == torch.bfloat16 and v.is_contiguous()
        assert v.data_ptr() == ptrs[k]
        # first step: the f32 update is -lr * g / (|g| + eps), then the cast
        gc = g[k].float() * min(1.0, 0.3 / float(global_norm(g)))
        gc = gc.to(torch.bfloat16).float()
        want = (ref[k].float() - 1e-2 * gc / (gc.abs() + 1e-8)) \
            .to(torch.bfloat16)
        assert torch.equal(v, want), k


def test_adamw_refuses_mismatched_keys():
    p = {"a": torch.zeros(2)}
    with pytest.raises(ValueError, match="differ in keys"):
        adamw_update(AdamWConfig(), {"b": torch.zeros(2)}, adamw_init(p), p)


class _Holder(nn.Module):
    def __init__(self, linears):
        super().__init__()
        self.lin = nn.ModuleList(linears)


def _qalora(seed=0):
    pol = schemes.QuantPolicy(bits=4, group_size=8, rank=2)
    return schemes.linear_init(torch.Generator().manual_seed(seed), 16, 8,
                               pol, device="cpu")


def test_trainable_tensors_are_exactly_the_adapters():
    m = _Holder([_qalora(0), _qalora(1),
                 schemes.dense_linear(torch.ones(4, 4))])
    tr, frozen = split_params(m)
    assert sorted(tr) == ["lin.0.ad.a", "lin.0.ad.b", "lin.1.ad.a",
                          "lin.1.ad.b"]
    assert {id(t) for t in tr.values()} == {id(t) for t in m.parameters()}
    assert "lin.0.q.qweight" in frozen and "lin.2.w" in frozen
    assert count_params(tr) == 2 * (2 * 2 + 2 * 8)
    assert count_params(m) == count_params(tr) + count_params(frozen)


def test_trainable_tensors_refuses_a_declared_key_that_is_missing():
    @schemes.register_scheme("qalora_misnamed")
    class Misnamed(schemes.QALoRAScheme):
        trainable = ("adapter",)
    try:
        lp = _qalora()
        bad = schemes.LinearParams(lp.data, scheme="qalora_misnamed",
                                   policy=lp.policy)
        with pytest.raises(ValueError, match="nothing would train"):
            trainable_tensors(_Holder([bad]))
    finally:
        schemes._REGISTRY.pop("qalora_misnamed")


def test_trainable_tensors_refuses_a_key_with_no_tensor():
    lp = _qalora()
    empty = schemes.LinearParams(
        {"q": schemes.quantized_base(lp), "ad": nn.Module()},
        scheme="qalora", policy=lp.policy)
    with pytest.raises(ValueError, match="selects zero tensors"):
        trainable_tensors(_Holder([empty]))


def test_trainable_tensors_refuses_a_parameter_no_scheme_declares():
    m = _Holder([_qalora()])
    m.stray = nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="no scheme declares"):
        trainable_tensors(m)


def test_schedules_match_reference_at_every_step():
    from repro.optim import cosine_schedule as r_cos
    from repro.optim import warmup_cosine as r_warm
    from repro_torch.optim import cosine_schedule, warmup_cosine
    cfg = dict(lr=1e-3, total_steps=10, warmup_steps=4)
    for step in range(0, 16):
        s = torch.tensor(step, dtype=torch.int32)
        for t_fn, r_fn in ((cosine_schedule, r_cos), (warmup_cosine, r_warm)):
            _close(t_fn(AdamWConfig(**cfg), s),
                   r_fn(RAdamW(**cfg), jnp.int32(step)), where=f"{step}")
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(RAdamW())
