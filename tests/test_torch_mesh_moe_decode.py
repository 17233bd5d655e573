"""MoE decode on a mesh of CPU processes (gloo): reduced mixtral-8x22b
(gqa_moe) and reduced deepseek-v3-671b (mla_moe: MLA's absorbed step, a
dense layer, sigmoid routing and a shared expert) through
``steps.make_decode_step`` and ``make_generate_step``, against the JAX
package's ``LM.decode_step`` and ``LM.generate`` without a mesh
(``tests/test_torch_mesh_decode.py``'s helpers and bound: f32, 1e-5 of
the largest logit, identical greedy tokens, each rank's ``k`` / ``v`` or
``c`` / ``kr`` its part of the reference's under the reference's
``cache_spec_tree``).

A decode step's rows route over the global batch (capacity the
reference's at T = B): on data 2 the experts' slots gather the rows of
both data ranks; with batch 1 the row is replicated (the positions split
over "data") and nothing is gathered.  The expert layouts: E = 4 over
data x model (one a rank on data 2 x model 2 and on model 4, two on model
2).  The caches: mixtral's 2 KV heads whole over model 2, their head_dim
over model 4; deepseek-v3's latent (32) and rope key (16) split over
"model", gathered whole each step.  One control must fail the bound:
mixtral's head_dim split without the partial scores' sum over "model"."""

import numpy as np
import pytest

from repro_torch.launch.mesh import run_ranks
from test_torch_mesh_decode import (DEADLINE, TOL, assembled_logits,
                                    check_case, rank_cases, reference)

# name: (arch, overrides, batch, prompt, capacity, generated), mesh sizes
CASES = {
    "mixtral_model2": (("mixtral-8x22b", {}, 2, 8, 12, 4), (1, 2)),
    "deepseek_model2": (("deepseek-v3-671b", {}, 2, 8, 12, 4), (1, 2)),
    "mixtral_data2_model2": (("mixtral-8x22b", {}, 2, 8, 12, 4), (2, 2)),
    "deepseek_data2_model2": (("deepseek-v3-671b", {}, 2, 8, 12, 4),
                              (2, 2)),
    "mixtral_seq_data2_model2": (("mixtral-8x22b", {}, 1, 6, 16, 11),
                                 (2, 2)),
    "mixtral_model4": (("mixtral-8x22b", {}, 2, 8, 12, 4), (1, 4)),
}


@pytest.fixture(scope="module")
def runs():
    refs = {name: reference(*case) for name, (case, _) in CASES.items()}
    out = {}
    for sizes in sorted({s for _, s in CASES.values()}):
        names = [n for n, (_, s) in CASES.items() if s == sizes]
        got = run_ranks(rank_cases, sizes[0] * sizes[1],
                        (sizes, {n: refs[n] for n in names}),
                        deadline_s=DEADLINE)
        out.update({n: [g[n] for g in got] for n in names})
    got = run_ranks(rank_cases, 4, ((1, 4), {"mixtral_model4":
                                             refs["mixtral_model4"]},
                                    "no_score_sum"), deadline_s=DEADLINE)
    out["control"] = [g["mixtral_model4"] for g in got]
    return refs, out


@pytest.mark.parametrize("name", list(CASES))
def test_moe_decode_and_generate_equal_reference(runs, name):
    refs, out = runs
    check_case(out[name], refs[name], CASES[name][1], name)


@pytest.mark.parametrize("name,layout", (
    ("mixtral_model2", ((), (), True, False)),
    ("mixtral_data2_model2", (("data",), (), True, False)),
    ("mixtral_seq_data2_model2", ((), ("data",), True, False)),
    ("mixtral_model4", ((), (), False, True)),
    ("deepseek_model2", ((), (), False, True)),
    ("deepseek_data2_model2", (("data",), (), False, True))))
def test_moe_layout_the_cache_spec_gives(runs, name, layout):
    _, out = runs
    assert all(tuple(g["layout"]) == layout for g in out[name])


def test_control_without_the_score_sum_fails(runs):
    refs, out = runs
    got = assembled_logits(out["control"], (1, 4))
    want = refs["mixtral_model4"].step
    assert np.abs(got - want).max() > TOL * np.abs(want).max()
