"""Roofline table of the port's dry-run records on the H100 (counterpart of
``benchmarks/roofline_report.py``).

Reads the records ``python -m repro_torch.launch.dryrun`` wrote (one
rank's counted step per cell) and prints, for each cell the port runs on
the mesh, the reference's table from
:func:`repro_torch.perf.roofline.roofline_terms` with the H100 figures of
:class:`~repro_torch.perf.roofline.HW`: compute, memory and collective
time, the dominant term, the share of the collective time in the MoE
expert exchange's all-to-alls (dispatch forward, combine backward; "-"
where a cell has none) and, for decode cells, in a step's partial-score
sums over "model", its log-sum-exp merges over the data axes and MLA's
latent gathers (the mesh's labelled collectives), MODEL_FLOPS, the useful ratio (MODEL_FLOPS over
the counted flops of every rank) and the next move; then the refused
cells and their reasons.  Writes the table and the rows as JSON.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        [--dryrun-dir experiments/dryrun_torch] [--mesh pod|multipod|both]

``--measure ARCH`` (on the card) also runs one step of ``--kind`` for
ARCH at its published widths, ``--batch`` sequences of ``--seq`` tokens
(a decode step: one token each at a context of ``--seq``), from seed 0,
eagerly: warm-up, ``--runs`` timed runs (median wall), one under
``torch.profiler`` (:func:`repro_torch.launch.profile_serve._profile`:
device-busy ms, idle share; its tables and trace under
``build/roofline_measure/``), then one counted (the counter's host cost
kept out of the timed runs); it prints the card's name and power limit,
the counted cost, the roofline terms of that step on one card and
``model_flops / (wall s x peak)``:

    python -m repro_torch.launch.roofline_report --measure gemma3-1b \\
        --kind prefill --batch 1 --seq 4096
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

from repro_torch.perf.cost import OpCost
from repro_torch.perf.roofline import HW, roofline_terms


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


BOTTLENECK_FIX = {
    "compute_s": "more TP (shrink each rank's products) or a lower-"
                 "precision tensor-core path",
    "memory_s": "cut activation traffic: fused kernels for the plain "
                "attention and elementwise chains, less remat",
    "collective_s": "reshard to cut all-gathers / overlap with compute",
}


def analyze(rec: dict) -> dict:
    """A record with its roofline terms on the H100 (``rec`` ok)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import build_config
    cfg = build_config(rec["arch"], rec.get("policy", ""),
                       rec.get("reduced", False))
    terms = roofline_terms(OpCost(**rec["cost"]), rec["n_devices"], cfg,
                           SHAPES[rec["cell"]], HW())
    by_op = rec.get("by_op", {})
    a2a = by_op.get("all_to_all")
    terms["all_to_all_s"] = (a2a["collective_bytes"] / HW().link_bw
                             if a2a else None)
    for label in DECODE_COLLECTIVES:
        terms[f"{label}_s"] = sum(
            v["collective_bytes"] for k, v in by_op.items()
            if k.endswith(f"[{label}]")) / HW().link_bw
    return {**{k: v for k, v in rec.items() if k != "by_op"}, **terms}


# the labelled collectives of a decode step on a mesh
# (repro_torch.models.attention): the partial scores' sum over "model"
# where head_dim splits, the log-sum-exp merge over the data axes where
# the positions split, MLA's latent and rope key gathered whole
DECODE_COLLECTIVES = ("score_sum", "lse_merge", "latent_gather")


def mla_decode_exchange(cfg, rows: int, seq: int, model: int) -> dict:
    """The collective bytes a rank's MLA decode step reports a layer (the
    counter's rule: each collective's operand), for each way to attend
    over a latent cache split over "model": ``gather_latent`` (the
    rank's block of ``c`` and ``kr`` all-gathered, bf16) and
    ``sum_scores`` (every head's absorbed query all-gathered, the partial
    scores of all heads summed over "model", each head's block of the
    context gathered back: f32)."""
    h, r, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    hl = h // model
    return {"gather_latent": rows * seq * (r + rope) // model * 2,
            "sum_scores": (rows * hl * (r + rope) * 4
                           + rows * h * seq * 4 + rows * h * r // model * 4)}


def load(dryrun_dir: str, meshes) -> list:
    """The records of every (config in ASSIGNED x cell x mesh) found."""
    import repro_torch.configs as C
    from repro_torch.launch.dryrun import cell_tag
    out = []
    for arch in C.ASSIGNED:
        for cell in C.cells_for(arch):
            for mesh in meshes:
                path = os.path.join(dryrun_dir,
                                    cell_tag(arch, cell.name, mesh) + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        out.append(json.load(f))
    return out


def table(rows) -> str:
    lines = ["| arch | shape | mesh | compute | memory | collective | "
             "of which all-to-all | of which score sums / lse merge / "
             "latent gather | bound | MODEL_FLOPS | useful | held GiB "
             "| next move |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        a2a = r.get("all_to_all_s")
        dec = [r.get(f"{k}_s") or 0.0 for k in DECODE_COLLECTIVES]
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | "
            f"{'-' if a2a is None else fmt_s(a2a)} | "
            f"{' / '.join(fmt_s(x) if x else '-' for x in dec)} | "
            f"{r['dominant'].replace('_s', '')} | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | "
            f"{r['memory']['total_bytes'] / 2**30:.2f} | "
            f"{BOTTLENECK_FIX[r['dominant']]} |")
    return "\n".join(lines)


def smi() -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def measure(arch: str, kind: str, batch: int, seq: int, runs: int = 3,
            out_dir: str = "build/roofline_measure") -> dict:
    """One step of ``kind`` for ``arch`` on the card (see the module
    docstring): wall ms (median of ``runs``), the profiled run's busy ms
    and idle share, the counted cost, the terms on one card and the
    roofline share ``model_flops / (wall s x peak)``."""
    import torch

    import repro_torch.configs as C
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import make_step, run_step
    from repro_torch.launch.profile_serve import _profile
    from repro_torch.models.lm import LM
    cfg = C.get(arch)
    lm = LM(cfg)
    dev = torch.device("cuda")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    if kind == "decode":
        cache = lm.init_cache(batch, seq + runs + 4, device=dev)
        cache["len"].fill_(seq)
        inputs = {"cache": cache, "tokens": toks[:, :1]}
    else:
        inputs = {"batch": {"tokens": toks, **({"labels": toks}
                                               if kind == "train" else {})}}

    once = make_step(lm, kind, params, inputs)
    once()  # warm-up (and the build of every kernel)
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = _profile(once, out_dir, f"{arch}_{kind}")
    cost = run_step(lm, kind, params, inputs).cost
    cell = ShapeCell(kind, kind, seq, batch)
    terms = roofline_terms(cost, 1, cfg, cell, HW())
    wall = statistics.median(walls)
    return {"card": smi(), "arch": arch, "kind": kind, "batch": batch,
            "seq": seq, "n_layers": cfg.n_layers, "wall_ms": wall,
            "walls_ms": walls, "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "cost": cost.as_dict(), **terms,
            "roofline_share": terms["model_flops"]
            / (wall / 1e3 * HW().peak_flops)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    ap.add_argument("--json-out", default="experiments/roofline_torch.json")
    ap.add_argument("--measure", metavar="ARCH")
    ap.add_argument("--kind", default="prefill",
                    choices=["train", "prefill", "decode"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)

    if args.measure:
        print(json.dumps({"roofline_measure": measure(
            args.measure, args.kind, args.batch, args.seq, args.runs)}))
        return
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    recs = load(args.dryrun_dir, meshes)
    rows = [analyze(r) for r in recs if r["ok"]]
    refused = [r for r in recs if not r["ok"]]
    text = table(rows)
    text += "\n\nRefused:\n" + "\n".join(
        f"- {r['arch']} {r['cell']} {r['mesh']}: {r['reason']}"
        for r in refused)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    with open(args.json_out, "w") as f:
        json.dump(rows + refused, f, indent=1)
    print(f"H100 figures: {HW()}")
    print(text)
    print(f"\n[{len(rows)} cells, {len(refused)} refused] -> {args.out}")


if __name__ == "__main__":
    main()
