"""Static serving driver: prefill + greedy decode with the merged QA-LoRA
model (counterpart of the static engine of ``repro.launch.serve``).

The paper's deployment claim: after the merge the served model is still
INT-N (codes and scales unchanged, zeros updated) and computes what the
adapter model computes (checked with ``--verify``).  On CUDA every
quantized linear runs in the port's hand-written kernels (the schemes
route CUDA tensors nowhere else): the merged model's prefill in the tiled
matmul and its decode in the GEMV; ``--verify`` runs the unmerged adapter
model through the fused QA-LoRA kernels at both M ranges.

    python -m repro_torch.launch.serve --arch llama7b-proxy \\
        --requests 4 --prompt-len 128 --gen-len 32 --verify
    python -m repro_torch.launch.serve --arch gemma3-1b --reduced \\
        --device cpu --requests 2 --prompt-len 8 --gen-len 6 --verify
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

NOT_PORTED = ("engine", "adapters", "speculate", "page_size")


def merge_model(params):
    """Merge every adapter into its quantized base (exact; Appendix B)."""
    from repro_torch.core.schemes import merge_tree
    return merge_tree(params)


@torch.no_grad()
def bump_adapters(params, delta: float = 0.01):
    """Add ``delta`` to every adapter leaf (A and B), in place, so the merge
    is not trivial (the reference's stand-in for a fine-tuned model)."""
    from repro_torch.core.schemes import adapter_params, map_linears

    def one(path, lp):
        if lp.scheme == "qalora":
            ad = adapter_params(lp)
            ad.a.add_(delta)
            ad.b.add_(delta)
        return lp
    map_linears(params, one)
    return params


def build_model(cfg, device, seed: int = 0):
    """The served model: random init from ``seed`` on ``device``, adapters
    nudged by +0.01, then merged.  Returns (lm, adapter params, merged
    params); the two share their codes and scales."""
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = bump_adapters(lm.init(gen, device))
    return lm, params, merge_model(params)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(lm, params, prompts, gen_len: int, max_len: int,
             cache_dtype=torch.float32, device="cuda"):
    """Prefill the prompts as one batch, embed the prefill cache into a
    full-capacity decode cache and decode greedily (the counterpart of
    ``generate_scan``).  Returns (tokens [B, gen_len] numpy, timings)."""
    b = prompts.shape[0]
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, pre = lm.prefill(params, {"tokens": toks})
    cache = lm.merge_prefill_cache(
        pre, lm.init_cache(b, max_len, dtype=cache_dtype, device=device))
    _sync(device)
    t1 = time.perf_counter()
    out, _ = lm.generate(params, cache, logits, gen_len)
    out = out.cpu().numpy()
    t2 = time.perf_counter()
    return out, {"prefill_s": t1 - t0, "decode_s": t2 - t1, "total_s": t2 - t0}


def generate_loop_reference(lm, params, prompts, gen_len: int, max_len: int,
                            cache_dtype=torch.float32, device="cuda"):
    """Per-token reference loop: the prompt too goes through decode steps.
    Returns (tokens [B, gen_len] numpy, seconds)."""
    b, prompt_len = prompts.shape
    if gen_len <= 0:
        return np.zeros((b, 0), np.int32), 0.0
    cache = lm.init_cache(b, max_len, dtype=cache_dtype, device=device)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    out, logits = [], None
    t0 = time.perf_counter()
    for i in range(prompt_len + gen_len - 1):
        nxt = (toks[:, i:i + 1] if i < prompt_len
               else logits.argmax(-1)[:, None].to(torch.int32))
        if i >= prompt_len:
            out.append(nxt[:, 0])
        logits, cache = lm.decode_step(params, cache, nxt)
    out.append(logits.argmax(-1).to(torch.int32))
    gen = torch.stack(out, 1).cpu().numpy()
    return gen, time.perf_counter() - t0


def merge_check(lm, params, merged, prompts, max_len: int,
                cache_dtype=torch.float32, device="cuda"):
    """The adapter model against the merged model: prefill logits, then one
    decode step on the merged model's greedy token.  Returns max|delta|
    and max|logits| of each."""
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    b = toks.shape[0]
    out = {}
    runs = {}
    for name, p in (("adapter", params), ("merged", merged)):
        logits, pre = lm.prefill(p, {"tokens": toks})
        cache = lm.merge_prefill_cache(
            pre, lm.init_cache(b, max_len, dtype=cache_dtype, device=device))
        runs[name] = (logits, cache)
    nxt = runs["merged"][0].argmax(-1).to(torch.int32)[:, None]
    step = {name: lm.decode_step(p, runs[name][1], nxt)[0]
            for name, p in (("adapter", params), ("merged", merged))}
    for phase, pair in (("prefill", (runs["adapter"][0], runs["merged"][0])),
                        ("decode", (step["adapter"], step["merged"]))):
        a, m = pair
        out[phase] = {"max_abs_diff": float((a - m).abs().max()),
                      "max_abs_logit": float(m.abs().max())}
    return out


def merge_bound(cfg) -> float:
    """Bound on max|adapter - merged| / max|logit|.  In f32 the two
    models differ only in summation order (the reference asserts 5e-2 in
    absolute terms at its reduced sizes); in bf16 each linear rounds its
    dequantised weights, and the merged zeros, to 8 significant bits, and
    the difference compounds over the layers."""
    return 0.05 if cfg.quant.dtype == torch.float32 else 0.10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--policy", default="",
                    help='per-layer policy rules, e.g. "*=int4,*/attn/wo=int8"')
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # serving modes of the reference that the port does not have yet
    ap.add_argument("--engine", default="static")
    ap.add_argument("--adapters", default="")
    ap.add_argument("--speculate", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0)
    args = ap.parse_args(argv)
    for name in NOT_PORTED:
        val = getattr(args, name)
        if val and val != "static":
            ap.error(f"--{name.replace('_', '-')} {val}: not yet ported, "
                     f"see ROADMAP.md (the port serves the static engine)")

    import repro_torch.configs as C
    from repro_torch.core.schemes import PolicyTree
    from repro_torch.models.lm import resolve_device

    device = resolve_device(args.device)
    cfg = C.reduced(args.arch) if args.reduced else C.get(args.arch)
    if args.policy:
        cfg = cfg.scaled(quant=PolicyTree.parse(args.policy,
                                                base=cfg.quant.default))
    t0 = time.perf_counter()
    lm, params, merged = build_model(cfg, device)
    _sync(device)
    init_s = time.perf_counter() - t0

    b = args.requests
    # an empty prompt still needs one token to condition on: feed BOS (=0)
    prompt_len = max(args.prompt_len, 1)
    max_len = prompt_len + args.gen_len
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(b, prompt_len)).astype(np.int32)
    if args.prompt_len == 0:
        prompts[:] = 0

    result = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "device": str(device), "requests": b, "prompt_len": prompt_len,
              "gen_len": args.gen_len, "init_s": init_s}
    toks, times = generate(lm, merged, prompts, args.gen_len, max_len,
                           device=device)
    result.update(times)
    result["decode_ms_per_token"] = (times["decode_s"] * 1e3
                                     / max(args.gen_len - 1, 1))
    result["tok_s"] = b * toks.shape[1] / max(times["total_s"], 1e-9)
    result["tokens"] = toks
    print(f"[serve] {b} requests x {toks.shape[1]} tokens in "
          f"{times['total_s']:.3f}s ({result['tok_s']:.1f} tok/s, "
          f"prefill+decode, {device})")
    print(f"[serve] sample generation: {toks[0][:8]}")

    if args.verify:
        check = merge_check(lm, params, merged, prompts, max_len,
                            device=device)
        bound = merge_bound(cfg)
        result["merge_check"] = check
        result["merge_bound_rel"] = bound
        for phase, r in check.items():
            rel = r["max_abs_diff"] / max(r["max_abs_logit"], 1e-30)
            r["rel"] = rel
            print(f"[serve] merge-exactness {phase}: max|adapter - merged| = "
                  f"{r['max_abs_diff']:.3e} ({rel:.2e} of max|logit|, "
                  f"bound {bound:.0e})")
            if not rel <= bound:
                raise AssertionError(f"merged model diverged from the adapter "
                                     f"model at {phase}: {rel:.3e} > {bound}")
    print("[serve] done")
    return result


if __name__ == "__main__":
    main()
