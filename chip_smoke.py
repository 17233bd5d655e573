#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does,
   and records its clocks, power draw and temperature (sampled again
   after each kernel timing).
2. build   -- builds the four dequant-matmul kernels from ``src/repro_torch/csrc``.
3. kernels -- holds each kernel against its plain PyTorch version on the
   card in bf16 at the main-path shapes of llama7b-proxy int4 g32 (M = 4
   for the GEMV kernels, M = 512 for the tiled ones), plus a sweep of bits
   {2, 3, 4, 8} and a sweep of the GEMV's M, and times kernel, plain
   version and one PyTorch matmul on the pre-dequantised weight
   (``library_ms``) with CUDA events, rotating over enough weight copies
   to keep the 50 MB L2 cold.
4. small   -- a reduced model on the card (kernels) against the same
   weights on the CPU (plain versions).
5. serve   -- ``repro_torch.launch.serve`` on the full llama7b-proxy
   (32 layers, d 4096, d_ff 11008, vocab 32000, int4 g32 r64, bf16):
   4 requests x 128 prompt + 32 generated tokens, then the merge check;
   all four kernels must have launched on that run.
6. the ``kernels`` summary, and the final ``{"ok": true, ...}`` line.

Any failed phase exits non-zero before the final line.  Without a card,
or without the repository's ``src`` beside this file, it exits non-zero
and prints no result.  Writes everything also to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12

# llama7b-proxy int4 g32 r64: (K, N) of the linears of one layer and how
# many of each a layer holds (wq/wk/wv/wo, gate/up, down)
SHAPES = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
BITS, GROUP, RANK, S = 4, 32, 64, 2.0
GEMV_M, TILED_M = 4, 512
SWEEP_SHAPE = (4096, 4096)
# the GEMV at M = 1, 4, 8 on one shape: a time that grows with M points at
# the multiply-adds, a flat one at the bytes in flight
GEMV_M_SWEEP = ((1, 8), (4096, 11008))
L2_BYTES = 50e6

KERNELS = {
    # name: (adapter?, M, source, Pallas function replaced)
    "qmatmul": (False, TILED_M, "src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:76"),
    "qmatvec": (False, GEMV_M, "src/repro_torch/csrc/qmatvec.cu",
                "src/repro/kernels/qmatvec.py:68"),
    "qalora_matmul": (True, TILED_M, "src/repro_torch/csrc/qalora_fused.cu",
                      "src/repro/kernels/qalora_fused.py:62"),
    "qalora_matvec": (True, GEMV_M, "src/repro_torch/csrc/qmatvec.cu",
                      "src/repro/kernels/qmatvec.py:133"),
}

RECORD = {"phases": []}


def emit(obj):
    RECORD["phases"].append(obj)
    print(json.dumps(obj), flush=True)


def save():
    try:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(RECORD, f, indent=1, default=str)
    except OSError as e:
        print(f"[chip_smoke] could not write {OUT_DIR}: {e}", file=sys.stderr)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def _smi(fields: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<fields>`` line."""
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# sampled beside the timings: a card below its clocks runs slower
CLOCKS = "clocks.sm,clocks.mem,clocks.max.sm,power.draw,temperature.gpu"


def phase_device(torch):
    line = _smi("name,power.limit")
    print(line, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "clocks": _smi(CLOCKS),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    per_source = build.build_all()
    secs = time.perf_counter() - t0
    for name in build.SOURCES:
        build.library(name)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.log"), "w") as f:
        for name, log in build.BUILD_LOG.items():
            f.write(f"==== {name}.cu\n{log}\n")
    emit({"phase": "build", "seconds": secs,
          "per_source_seconds": per_source, "sources": list(build.SOURCES)})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _bound(m, k, n, bits, adapter, scale_bytes=2, ab_bytes=2, x_bytes=2):
    """Least time for the work: bytes (each input read once, the output
    written once) over the memory rate, or operations over the bf16 peak."""
    from repro_torch.core.quant import codes_per_byte
    groups = k // GROUP
    nbytes = (k // codes_per_byte(bits)) * n + 2 * groups * n * scale_bytes \
        + m * k * x_bytes + m * n * x_bytes
    flops = 2 * m * k * n
    if adapter:
        nbytes += (groups * RANK + RANK * n) * ab_bytes
        flops += 2 * m * (groups * RANK + RANK * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_ms(torch, fn, arg_sets, iters):
    """CUDA-event time of one call, over ``iters`` calls rotating through
    ``arg_sets`` (distinct weight copies, so the L2 stays cold)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case(torch, gen, m, k, n, bits, adapter):
    """Inputs for one kernel call: quantized weight, adapter, x (bf16)."""
    from repro_torch.core import quant
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quant.quantize(w, bits, GROUP, scale_dtype=torch.bfloat16)
    del w
    a = (torch.randn((k // GROUP, RANK), generator=gen, device="cuda")
         / math.sqrt(k // GROUP) + 0.01).to(torch.bfloat16)
    b = (torch.randn((RANK, n), generator=gen, device="cuda") * 0.01
         + 0.01).to(torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    return qt, a, b, x


def _calls(name):
    from repro_torch import kernels
    from repro_torch.kernels import qalora_fused, qmatmul, qmatvec
    plain = {"qmatmul": qmatmul.qmatmul_plain, "qmatvec": qmatvec.qmatvec_plain,
             "qalora_matmul": qalora_fused.qalora_matmul_plain,
             "qalora_matvec": qmatvec.qalora_matvec_plain}[name]
    return kernels.KERNELS[name], plain


def _check_one(torch, name, m, k, n, bits, gen, timing):
    """Kernel vs plain on one shape; optional timings.  Tolerance: both
    round w to bf16 at the same point and multiply exactly in f32, so
    they differ only in f32 summation order (and, with an adapter, where a
    pooled sum rounds to bf16): each bf16 output may land on a
    neighbouring value, two bf16 steps of the largest output at most,
    2**-6 * max|y|."""
    from repro_torch.core.schemes import LinearParams, QuantPolicy, dense_view
    from repro_torch.core.qalora import QALoRAParams
    adapter = KERNELS[name][0]
    kern, plain = _calls(name)
    qt, a, b, x = _case(torch, gen, m, k, n, bits, adapter)

    def args_of(q):
        base = (x, q.qweight, q.scale, q.zero)
        return base + ((a, b) if adapter else ())
    kw = dict(bits=bits, group_size=GROUP)
    if adapter:
        kw["s"] = S
    y = kern(*args_of(qt), **kw)
    ref = plain(*args_of(qt), **kw)
    torch.cuda.synchronize()
    yf, rf = y.float(), ref.float()
    err = (yf - rf).abs().max().item()
    tol = 2.0 ** -6 * rf.abs().max().item()
    row = {"kernel": name, "M": m, "K": k, "N": n, "bits": bits,
           "max_abs_err": err, "tol": tol,
           "finite": bool(torch.isfinite(yf).all())}
    row.update(_bound(m, k, n, bits, adapter))
    if timing:
        per_copy = qt.qweight.numel() + 4 * qt.scale.numel()
        copies = [qt] + [_case(torch, gen, m, k, n, bits, adapter)[0]
                         for _ in range(max(1, math.ceil(2.5 * L2_BYTES
                                                         / per_copy)) - 1)]
        row["kernel_ms"] = _time_ms(
            torch, lambda *t: kern(*t, **kw), [args_of(q) for q in copies], 50)
        row["clocks"] = _smi(CLOCKS)
        row["plain_ms"] = _time_ms(
            torch, lambda *t: plain(*t, **kw), [args_of(q) for q in copies], 5)
        pol = QuantPolicy(mode="qalora" if adapter else "intq", bits=bits,
                          group_size=GROUP, rank=RANK, s=S)
        dense = []
        for q in copies[:max(2, math.ceil(2.5 * L2_BYTES / (2 * k * n)))]:
            data = {"q": q, "ad": QALoRAParams(a, b)} if adapter else {"q": q}
            dense.append(dense_view(LinearParams(data, pol.mode, pol),
                                    torch.bfloat16))
        while len(dense) < 2:
            dense.append(dense[0].clone())
        row["library_ms"] = _time_ms(
            torch, lambda w: x @ w, [(w,) for w in dense], 50)
        del copies, dense
    ok = row["finite"] and err <= tol
    row["ok"] = ok
    emit({"phase": "kernel_row", **row})
    if not ok:
        raise AssertionError(f"{name} M={m} K={k} N={n} bits={bits}: "
                             f"max_abs_err {err} > tol {tol}")
    return row


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (adapter, m, _, _) in KERNELS.items():
        rows[name] = [_check_one(torch, name, m, k, n, BITS, gen, timing=True)
                      for k, n, _ in SHAPES]
    sweep = [_check_one(torch, name, KERNELS[name][1], *SWEEP_SHAPE, bits, gen,
                        timing=False)
             for bits in (2, 3, 4, 8) for name in KERNELS]
    ms, (k, n) = GEMV_M_SWEEP
    sweep += [_check_one(torch, "qmatvec", m, k, n, BITS, gen, timing=True)
              for m in ms]
    emit({"phase": "kernels_checked", "rows": sum(map(len, rows.values()))
          + len(sweep), "tolerance": "2**-6 * max|plain| (two bf16 steps)",
          "clocks_after": _smi(CLOCKS)})
    torch.cuda.empty_cache()
    return rows


def _per_layer(rows, key):
    """Sum of one layer's linears: 4 x (4096, 4096) + 2 x (4096, 11008) +
    1 x (11008, 4096)."""
    return sum(r[key] * count for r, (_, _, count) in zip(rows, SHAPES))


# ---------------------------------------------------------------------------
# phase 4: a reduced model on the card against the CPU
# ---------------------------------------------------------------------------


def phase_small(torch):
    """Reduced llama7b-proxy in bf16: kernel path on the card against the
    plain path on the CPU, same weights.  Bound: bf16 activations round
    at slightly different places on the two sides (kernel vs plain
    summation order), 5e-2 of max|logit|."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.core.schemes import QuantPolicy
    from repro_torch.launch.serve import bump_adapters, merge_model
    from repro_torch.models.lm import LM
    pol = QuantPolicy(bits=4, group_size=16, rank=4, dtype=torch.bfloat16,
                      scale_dtype=torch.bfloat16)
    cfg = C.reduced("llama7b-proxy", quant=pol)
    lm = LM(cfg)
    params = bump_adapters(lm.init(torch.Generator().manual_seed(0), "cpu"))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, size=(2, 12)).astype(np.int32))
    out = {"phase": "small", "arch": cfg.name, "d_model": cfg.d_model,
           "n_layers": cfg.n_layers}
    for which, p in (("adapter", params), ("merged", merge_model(params))):
        cpu_logits, _ = lm.prefill(p, {"tokens": prompts})
        gpu = copy.deepcopy(p).to("cuda")  # CUDA tensors: the kernels
        gpu_logits, _ = lm.prefill(gpu, {"tokens": prompts.cuda()})
        diff = (gpu_logits.cpu() - cpu_logits).abs().max().item()
        rel = diff / cpu_logits.abs().max().item()
        out[which] = {"max_abs_diff": diff, "rel": rel}
        if not rel <= 5e-2:
            emit({**out, "ok": False})
            raise AssertionError(f"small {which}: card vs CPU rel {rel}")
    emit({**out, "ok": True, "bound_rel": 5e-2})


# ---------------------------------------------------------------------------
# phase 5: serve the full model
# ---------------------------------------------------------------------------


def phase_serve(torch):
    from repro_torch import kernels
    from repro_torch.launch import serve
    argv = ["--arch", "llama7b-proxy", "--requests", "4", "--prompt-len", "128",
            "--device", "cuda"]
    serve.main(argv + ["--gen-len", "2"])  # warm-up: first-call set-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = serve.main(argv + ["--gen-len", "32", "--verify"])
    torch.cuda.synchronize()
    counts = kernels.launches()
    toks = res.pop("tokens")
    n_layers = res["n_layers"]
    checks = {
        "tokens_shape": list(toks.shape) == [4, 32],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < 32000)).all()),
        "merge_finite": all(math.isfinite(r["max_abs_diff"])
                            for r in res["merge_check"].values()),
        "all_kernels_launched": all(v > 0 for v in counts.values()),
    }
    out = {"phase": "serve", **res, "launches": counts,
           "launches_per_prefill": 7 * n_layers,
           "launches_per_decode_step": 7 * n_layers,
           "prefill_ms": res["prefill_s"] * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "depth_cut": "none (all 32 layers)", "checks": checks,
           "sample_tokens": toks[0][:8].tolist()}
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"serve checks failed: {checks}")
    return counts


# ---------------------------------------------------------------------------


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] {SRC}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    # plain versions compute in full f32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        smi_line = phase_device(torch)
        phase_build()
        rows = phase_kernels(torch)
        phase_small(torch)
        counts = phase_serve(torch)
    except Exception as e:  # report, save and fail: no result line
        import traceback
        traceback.print_exc()
        RECORD["error"] = repr(e)
        save()
        return 1
    summary = []
    for name, (adapter, m, source, replaces) in KERNELS.items():
        r = rows[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": _per_layer(r, "kernel_ms"),
            "plain_ms": _per_layer(r, "plain_ms"),
            "bound_ms": _per_layer(r, "bound_ms"),
            "bound_by": r[1]["bound_by"],
            "library_ms": _per_layer(r, "library_ms"),
            "work": f"one layer's linears at M={m}: 4x(4096,4096) + "
                    f"2x(4096,11008) + 1x(11008,4096), int4 g32, bf16",
            "status": "ported, checked"})
    RECORD["seconds"] = time.perf_counter() - t0
    RECORD["card"] = smi_line
    save()
    print(smi_line, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
