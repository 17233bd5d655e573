"""Where the serve path's time goes on the card: ``torch.profiler`` over
one prefill and a window of decode steps of the merged model.

    python -m repro_torch.launch.profile_serve --arch llama7b-proxy \\
        --requests 4 --prompt-len 128 --steps 8 --out chiprun_out/profile

Prints one JSON line per phase (prefill, decode): wall ms (host clock
around work ending in ``torch.cuda.synchronize()``), device-busy ms (the
sum of the kernels' own device time), the device's idle share, and the
device time grouped by kind (the port's GEMV / tiled kernels, matrix
products in PyTorch, everything else).  Writes the profiler tables and a
Chrome trace per phase under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _kind(name: str) -> str:
    if "gemv_kernel" in name:
        return "gemv (port)"
    if "tiled_kernel" in name:
        return "tiled (port)"
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
    busy_us = 0.0
    for evt in events:
        us = _device_us(evt)
        if us <= 0 or evt.device_type.name != "CUDA":
            continue
        busy_us += us
        kinds[_kind(evt.key)] = kinds.get(_kind(evt.key), 0.0) + us / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}_table.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total"
                             if hasattr(events[0], "self_device_time_total")
                             else "self_cuda_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_ms_by_kind": kinds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama7b-proxy")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from repro_torch.launch.serve import build_model
    from repro_torch.models.lm import resolve_device

    dev = resolve_device("cuda")
    cfg = C.get(args.arch)
    lm, _, merged = build_model(cfg, dev)
    b, s = args.requests, args.prompt_len
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        4, cfg.vocab, size=(b, s)).astype(np.int32), device=dev)
    max_len = s + args.steps + 4

    state = {}

    def prefill():
        logits, pre = lm.prefill(merged, {"tokens": toks})
        state["cache"] = lm.merge_prefill_cache(
            pre, lm.init_cache(b, max_len, dtype=torch.float32, device=dev))
        state["tok"] = logits.argmax(-1).to(torch.int32)[:, None]

    def decode(steps):
        def run():
            for _ in range(steps):
                lg, state["cache"] = lm.decode_step(merged, state["cache"],
                                                    state["tok"])
                state["tok"] = lg.argmax(-1).to(torch.int32)[:, None]
        return run

    prefill()           # warm-up: first-call set-up
    decode(2)()
    res = {"prefill": _profile(prefill, args.out, "prefill"),
           "decode": _profile(decode(args.steps), args.out, "decode")}
    res["decode"]["per_step_wall_ms"] = res["decode"]["wall_ms"] / args.steps
    res["decode"]["per_step_busy_ms"] = (res["decode"]["device_busy_ms"]
                                         / args.steps)
    for phase, r in res.items():
        print(json.dumps({"phase": phase, "arch": cfg.name, "requests": b,
                          "prompt_len": s, "device": torch.cuda.get_device_name(0),
                          **r}), flush=True)
    return res


if __name__ == "__main__":
    main()
