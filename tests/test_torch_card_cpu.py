"""The weights of chip_smoke.py's card-vs-CPU checks (``_card_cpu``).

Those checks hold the card (bf16 kernels) against the CPU (f32 plain
versions) at narrow shapes within 5e-2 of max|logit|.  Here, on the CPU
alone, the port in bf16 runs the same engines against the same weights
in f32, each MoE call routed and each step committing as the bf16 run
did: the gap is what bf16 itself leaves, with no card and no kernel.
The serve demo's nudge (0.01 added to every entry of B) puts a rank-one
term into each merged linear whose gain bf16 rounding rides on, so the
checks run the base as initialised, where bf16 stays within the bound.
"""

import contextlib
import copy
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs as C
from repro_torch.core import schemes
from repro_torch.launch import serve
from repro_torch.models.lm import LM
from repro_torch.models.moe import record_routing
from repro_torch.serving import ContinuousEngine, make_self_drafter, make_trace


def _smoke():
    """chip_smoke.py as a module (its top level defines constants and
    functions only; nothing runs on import)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _case(name):
    """(config, engine modes, requests, trace, drafter) of one of the
    smoke's card-vs-CPU checks."""
    s = SMOKE
    if name == "mixtral-8x22b":
        return (C.get(s.MOE_ARCH).scaled(**s.MOE_SPEC_CPU_OVER),
                (("spec", dict(speculate=s.SPEC_K, decode_burst=1)),),
                s.MLA_CPU_REQUESTS, s.MLA_CPU_TRACE, s.MOE_SPEC_DRAFTER)
    if name == "deepseek-v3-671b":
        return (C.get(s.MLA_ARCH).scaled(**s.MLA_CPU_OVER),
                (("plain", dict(decode_burst=8)),
                 ("mtp", dict(speculate=1, drafter="mtp", decode_burst=1))),
                s.MLA_CPU_REQUESTS, s.MLA_CPU_TRACE, None)
    return (C.get(name).scaled(**s.REC_CPU_OVER[name]),
            (("plain", dict(decode_burst=8)),),
            s.REC_CPU_REQUESTS, s.REC_CPU_TRACE, None)


def _bf16_against_f32(name, bump):
    """Per engine mode, the largest |bf16 - f32| / max|f32 logit| over
    every logged step's consumed rows."""
    cfg, modes, requests, trace_kw, drafter = _case(name)
    routed = cfg.family in ("gqa_moe", "mla_moe")
    lm, _, merged = serve.build_model(cfg, "cpu", bump=bump)
    f32_lm = LM(cfg.scaled(quant=dataclasses.replace(
        cfg.quant, dtype=torch.float32, scale_dtype=torch.float32)))
    f32_tree = copy.deepcopy(merged).float()
    drafts = {}
    if drafter is not None:
        d = make_self_drafter(merged, drafter, base=cfg.quant.default)
        drafts = {"bf16": d, "f32": copy.deepcopy(d).float()}
    trace = make_trace(requests, cfg.vocab, **trace_kw)
    kw = dict(n_slots=requests, prefill_chunk=max(trace_kw["prompt_lens"]),
              max_len=max(trace_kw["prompt_lens"])
              + max(trace_kw["gen_lens"])
              + max(e.get("speculate", 0) for _, e in modes) + 1)
    worst = {}
    for mode, ekw in modes:
        logs, own = {"bf16": [], "f32": []}, []
        for side, (side_lm, tree) in (("bf16", (lm, merged)),
                                      ("f32", (f32_lm, f32_tree))):
            extra = ({"drafter": drafts[side]}
                     if drafts and ekw.get("speculate") else {})
            if side == "bf16":
                held = (record_routing() if routed
                        else contextlib.nullcontext([]))
            else:
                held = (SMOKE._routed_by_call(torch, routes, own) if routed
                        else contextlib.nullcontext())
            force = logs["bf16"] if side == "f32" else None
            with held as rec, SMOKE._logit_log(torch, side_lm, logs[side],
                                                force=force):
                eng = ContinuousEngine(side_lm, tree, eager=True, **kw,
                                       **ekw, **extra)
                for r in trace:
                    eng.submit(r.prompt, r.max_new_tokens, rid=r.rid)
                eng.run()
            if side == "bf16":
                routes = list(rec)
        assert len(logs["bf16"]) == len(logs["f32"])
        worst[mode] = 0.0
        for (na, la, valid), (nb, lb, _) in zip(logs["bf16"], logs["f32"]):
            assert na == nb and la.shape == lb.shape
            if not bool(valid.any()):
                continue
            top = float(lb[valid].abs().max())
            worst[mode] = max(worst[mode], float(
                (la[valid] - lb[valid]).abs().max()) / top)
    return worst


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b",
                                  "rwkv6-7b", "zamba2-7b"])
def test_base_as_initialised_bf16_tracks_f32(name):
    worst = _bf16_against_f32(name, bump=False)
    assert all(w <= SMOKE.MLA_CPU_TOL for w in worst.values()), worst


def test_nudged_model_bf16_leaves_f32():
    """The control: with the nudge, bf16 leaves f32 far past the bound
    (zamba2-7b's narrow shape: by ~2 of max|logit|)."""
    worst = _bf16_against_f32("zamba2-7b", bump=True)
    assert worst["plain"] > 10 * SMOKE.MLA_CPU_TOL, worst


def test_nudge_is_a_rank_one_gain():
    """The nudge lifts each merged linear's largest singular value far
    over the next one, which the base leaves nearly equal."""
    cfg = _case("mixtral-8x22b")[0]
    ratio = {}
    for bump in (True, False):
        _, _, merged = serve.build_model(cfg, "cpu", bump=bump)
        lin = merged.blocks[0]["attn"]["wq"]
        sv = torch.linalg.svdvals(schemes.dense_view(lin).float())
        ratio[bump] = float(sv[0] / sv[1])
    assert ratio[True] > 8 and ratio[False] < 1.2, ratio
