"""Where the serve path's time goes on the card: ``torch.profiler`` over
one prefill and a window of decode steps of the merged model (static
engine), or over one ragged step and one decode burst of the continuous
engine serving demo tenants over one INT4 base.  The serve steps replay
their captured CUDA graphs (captured by a warm-up first); ``--loop``
profiles the same steps run op by op (the eager reference).

    python -m repro_torch.launch.profile_serve --arch llama7b-proxy \\
        --requests 4 --prompt-len 128 --steps 8 --out chiprun_out/profile
    python -m repro_torch.launch.profile_serve --arch llama7b-proxy \\
        --engine continuous --requests 4 --prompt-len 128 [--loop]

The continuous engine runs as ``chip_smoke.py``'s adapters phase does:
one slot per request, 64-token prefill chunks, bursts of 8, 32 tokens
per request, tenants alice, bob and carol (demo seeds 1-3) and the null
adapter.

The continuous engine serves the requests once to capture its steps, then
once more without the profiler (phase ``run``: wall ms, tok/s, ms per
ragged step and per decode model step, from ``EngineStats``), then profiles
the first ragged step and the first burst of a third pass.  Prints one JSON line per
profiled phase (prefill and decode, or ragged and burst):
wall ms (host clock around work ending in ``torch.cuda.synchronize()``),
device-busy ms (the sum of the kernels' own device time), the device's
idle share, the number of kernels the device ran, the device time and
kernel count grouped by kind (the port's GEMV / tiled kernels, matrix
products in PyTorch, everything else), the kernels that took the most
device time, and the host operations that took the most host time.  Writes the profiler tables and a Chrome trace per
phase under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


# the continuous engine's settings (those of chip_smoke.py's adapters phase)
PREFILL_CHUNK, DECODE_BURST, GEN_LEN = 64, 8, 32
TENANTS = ("alice=demo:1", "bob=demo:2", "carol=demo:3")


def _kind(name: str) -> str:
    if "gemv_kernel" in name:
        return "gemv (port)"
    if "tiled_kernel" in name:
        return "tiled (port)"
    if "rank_proj_kernel" in name:
        return "rank projection (port)"
    if any(t in name.lower() for t in ("gemm", "cutlass", "cublas", "sm90_xmma")):
        return "matmul (torch)"
    return "other (torch)"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile(fn, out_dir: str, tag: str):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kinds: dict = {}
    counts: dict = {}
    busy_us = 0.0
    for evt in events:
        us = _device_us(evt)
        if us <= 0 or evt.device_type.name != "CUDA":
            continue
        busy_us += us
        kind = _kind(evt.key)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        counts[kind] = counts.get(kind, 0) + evt.count
    host = sorted((e for e in events if e.device_type.name == "CPU"),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    top = sorted((e for e in events if e.device_type.name == "CUDA"
                  and _device_us(e) > 0), key=lambda e: -_device_us(e))[:12]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}_table.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total"
                             if hasattr(events[0], "self_device_time_total")
                             else "self_cuda_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_kernels": sum(counts.values()),
            "device_ms_by_kind": kinds, "device_kernels_by_kind": counts,
            "device_top": [{"kernel": e.key[:100], "calls": e.count,
                            "device_ms": _device_us(e) / 1e3} for e in top],
            "host_top": [{"op": e.key, "calls": e.count,
                          "self_host_ms": e.self_cpu_time_total / 1e3}
                         for e in host]}


def _static(lm, merged, toks, args, dev):
    """One prefill, then ``--steps`` decode steps of the merged model
    through :meth:`LM.generate` (one replay a step, or op by op under
    ``--loop``), on one decode cache kept across the passes."""
    from repro_torch.runtime.graphs import StepGraphs
    b, s = toks.shape
    cache = lm.init_cache(b, s + args.steps + 1, dtype=torch.float32,
                          device=dev)
    graphs = StepGraphs("serve.decode", dev, eager=args.loop)
    state = {}

    def prefill():
        state["logits"], pre = lm.prefill(merged, {"tokens": toks})
        lm.merge_prefill_cache(pre, cache)

    def decode():
        lm.generate(merged, cache, state["logits"], args.steps + 1,
                    graphs=graphs)

    prefill()           # warm-up: first-call set-up and the capture
    decode()
    res = {"prefill": _profile(prefill, args.out, "prefill"),
           "decode": _profile(decode, args.out, "decode")}
    res["decode"]["model_steps"] = args.steps
    res["decode"]["captures"] = graphs._cache_size()
    return res


def _continuous(lm, params, toks, args, dev):
    """One :class:`ContinuousEngine`, every request bound round-robin to
    the tenants and the null adapter: a first pass captures its steps, a
    second is timed without the profiler, and the first ragged step and
    the first decode burst of a third are profiled."""
    from repro_torch.launch.serve import build_store
    from repro_torch.serving import ContinuousEngine
    store, tenants = build_store(params, TENANTS)
    cycle = [*tenants, None]
    prompts = toks.cpu().numpy()
    eng = ContinuousEngine(
        lm, store.base, n_slots=toks.shape[0],
        max_len=toks.shape[1] + GEN_LEN, prefill_chunk=PREFILL_CHUNK,
        decode_burst=DECODE_BURST, adapters=store, eager=args.loop)

    def submit():
        eng.reset()
        for i, p in enumerate(prompts):
            eng.submit(p, GEN_LEN, adapter_id=cycle[i % len(cycle)])

    submit()
    eng.run()           # warm-up: first-call set-up and the captures
    submit()
    eng.run()           # a whole run without the profiler
    st = eng.stats
    res = {"run": {"wall_ms": st.seconds * 1e3, "tok_s": st.tok_per_s,
                   "ragged_ms_per_step": st.ragged_seconds * 1e3
                   / max(st.ragged_dispatches, 1),
                   "decode_ms_per_step": (st.seconds - st.ragged_seconds)
                   * 1e3 / max(st.model_steps - PREFILL_CHUNK
                               * st.ragged_dispatches, 1),
                   "captures": {g.name: g._cache_size()
                                for g in eng.graphs.values()}}}
    submit()
    res["ragged"] = _profile(eng.step_once, args.out, "ragged")
    while any(s is not None and s.prefilling for s in eng.sched.slots):
        eng.step_once()
    steps = eng.stats.model_steps
    res["burst"] = _profile(eng.step_once, args.out, "burst")
    res["burst"]["model_steps"] = eng.stats.model_steps - steps
    res["ragged"]["tenants"] = tenants
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama7b-proxy")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps profiled (static engine)")
    ap.add_argument("--loop", action="store_true",
                    help="profile the steps run op by op (the eager "
                         "reference) instead of their CUDA-graph replays")
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from repro_torch.launch.serve import build_model
    from repro_torch.models.lm import resolve_device

    dev = resolve_device("cuda")
    cfg = C.get(args.arch)
    lm, params, merged = build_model(cfg, dev)
    b, s = args.requests, args.prompt_len
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        4, cfg.vocab, size=(b, s)).astype(np.int32), device=dev)
    res = (_static(lm, merged, toks, args, dev) if args.engine == "static"
           else _continuous(lm, params, toks, args, dev))
    for phase, r in res.items():
        steps = r.get("model_steps", 1)
        r["per_step_wall_ms"] = r["wall_ms"] / steps
        if "device_busy_ms" in r:
            r["per_step_busy_ms"] = r["device_busy_ms"] / steps
        print(json.dumps({"phase": phase, "engine": args.engine,
                          "path": "eager" if args.loop else "graphs",
                          "arch": cfg.name, "requests": b, "prompt_len": s,
                          "device": torch.cuda.get_device_name(0), **r}),
              flush=True)
    return res


if __name__ == "__main__":
    main()
