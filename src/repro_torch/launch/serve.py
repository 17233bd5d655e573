"""Serving driver: the merged QA-LoRA model through the static engine
(prefill + greedy decode), or many QA-LoRA tenants over one INT-N base
through the continuous engine (counterpart of ``repro.launch.serve``).

The paper's deployment claim: after the merge the served model is still
INT-N (codes and scales unchanged, zeros updated) and computes what the
adapter model computes (checked with ``--verify``).  On CUDA every
quantized linear runs in the port's hand-written kernels (the schemes
route CUDA tensors nowhere else): the merged model's prefill in the tiled
matmul and its decode in the GEMV; ``--verify`` runs the unmerged adapter
model through the fused QA-LoRA kernels at both M ranges.

``--engine continuous`` serves through
:class:`repro_torch.serving.ContinuousEngine`; with ``--adapters
name=<source>,...`` each tenant's adapters are banked in one
:class:`repro_torch.serving.AdapterStore`, and requests cycle the tenants
and the null adapter round-robin.  A source is ``demo:<seed>`` (the
adapter model plus seeded noise on its adapters) or a checkpoint written
by ``repro_torch.launch.train`` (its directory, for the newest complete
step, or one step's directory), whose adapters are served over the base
they were trained on: the model built from ``--seed`` on this device, its
adapters as initialised.  Decode steps then run the slot GEMV kernel (one
adapter per row); ``--verify`` holds each tenant's slot-routed logits to
its merged tree.  ``--page-size`` pages the continuous engine's cache
(``--n-pages`` sizes the pool), and ``--speculate k`` drafts k tokens a
slot per decode dispatch with a reduced-bits copy of the served model
(``--draft-policy``, default ``*=intq8``) and verifies them in one step.

``--engine frontend`` serves the same engine behind
:class:`repro_torch.serving.ServingFrontend`: submit-time admission bounded
by ``--queue-cap`` (overload is REJECTED with the queue depth), deadlines
(``--deadline-ms``, ``--ttft-deadline-ms``), and with ``--inject-faults`` a
seeded :class:`~repro_torch.runtime.fault.FaultInjector` (a crash at
dispatch 5, stragglers) whose crashes the frontend recovers token for
token; the run sits inside a ``PreemptionGuard`` (SIGTERM drains it).  It
takes the continuous engine's ``--adapters``, ``--page-size``,
``--n-pages``, ``--speculate`` and ``--draft-policy``, and prints the status
counts, the recoveries and the SLO line.

    python -m repro_torch.launch.serve --arch llama7b-proxy \\
        --requests 4 --prompt-len 128 --gen-len 32 --verify
    python -m repro_torch.launch.serve --arch llama7b-proxy \\
        --engine continuous --slots 4 --prefill-chunk 64 --decode-burst 8 \\
        --requests 8 --prompt-len 128 --gen-len 32 \\
        --adapters alice=demo:1,bob=demo:2,carol=demo:3 --verify
    python -m repro_torch.launch.serve --arch llama7b-proxy \
        --engine continuous --slots 4 --prefill-chunk 64 --requests 4 \
        --prompt-len 128 --gen-len 32 --page-size 16 --speculate 3 \
        --draft-policy "*=intq8"
    python -m repro_torch.launch.serve --arch gemma3-1b --reduced \\
        --device cpu --requests 2 --prompt-len 8 --gen-len 6 --verify
    python -m repro_torch.launch.serve --arch gemma3-1b --reduced \\
        --device cpu --engine frontend --requests 6 --slots 2 \\
        --gen-len 8 --queue-cap 4 --inject-faults
    python -m repro_torch.launch.serve --arch llama7b-proxy \\
        --engine continuous --adapters tuned=build/ckpt --verify
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def merge_model(params):
    """Merge every adapter into its base: a ``qalora`` linear stays INT-N
    (exact; Appendix B), a ``lora`` or ``qlora`` one becomes fp (the '4+16'
    model)."""
    from repro_torch.core.schemes import merge_tree
    return merge_tree(params)


@torch.no_grad()
def bump_adapters(params, delta: float = 0.01):
    """Add ``delta`` to every adapter leaf (A and B of each ``qalora``,
    ``lora`` and ``qlora`` linear, the head's too), in place, so the merge
    is not trivial (the reference's stand-in for a fine-tuned model)."""
    from repro_torch.core.schemes import trainable_tensors
    for t in trainable_tensors(params).values():
        t.add_(delta)
    return params


@torch.no_grad()
def demo_tenant(params, seed: int, scale: float = 0.02):
    """A stand-in fine-tune of the adapter model ``params``: every adapter
    leaf (of each ``qalora``, ``lora`` or ``qlora`` linear) plus ``scale``
    times normal noise from a generator seeded with ``1000 + seed`` (the
    reference's demo tenants).  The bases are shared with ``params``, not
    copied."""
    from repro_torch.core import schemes
    gen = None

    def one(path, lp):
        nonlocal gen
        keys = schemes.get_scheme(lp.scheme).trainable_paths(lp.data)
        if not keys:
            return lp
        ad = schemes.adapter_params(lp)
        if gen is None:
            gen = torch.Generator(device=ad.a.device).manual_seed(1000 + seed)

        def noisy(t):
            return t + scale * torch.randn(t.shape, generator=gen,
                                           device=t.device).to(t.dtype)
        return schemes.LinearParams(
            {**lp.data, keys[0]: type(ad)(noisy(ad.a), noisy(ad.b))},
            scheme=lp.scheme, policy=lp.policy, exempt=lp.exempt)
    return schemes.map_linears(params, one)


def checkpoint_tenant(params, path: str, meta: dict):
    """The adapter model ``params`` with its adapters replaced by those of
    a checkpoint written by ``repro_torch.launch.train``: ``path`` is the
    trainer's ``--ckpt-dir`` (its newest complete step) or one step's
    directory.  ``meta`` is :func:`repro_torch.launch.train.train_meta` of
    ``params``; a checkpoint written for another model, policy, seed or
    device, or whose adapter shapes differ, raises ValueError.  The
    quantized bases are shared with ``params``."""
    import os
    from repro_torch import checkpoint
    from repro_torch.core import schemes
    from repro_torch.core.qalora import QALoRAParams
    from repro_torch.launch.train import meta_mismatch
    if not checkpoint.is_complete(path):
        steps = (checkpoint.complete_steps(path) if os.path.isdir(path)
                 else [])
        if not steps:
            raise ValueError(f"{path!r} holds no complete checkpoint "
                             f"written by repro_torch.launch.train")
        path = checkpoint.step_path(path, steps[-1])
    got = checkpoint.read_meta(path)
    # a qalora entry starts with its bits; lora and qlora with the scheme
    other = sorted({p[0] for p in got.get("policy", {}).values()
                    if isinstance(p[0], str)})
    if other:
        raise ValueError(f"checkpoint {path!r} holds {'/'.join(other)} "
                         f"adapters; --adapters serves only qalora "
                         f"adapters (the AdapterStore banks group-pooled "
                         f"adapters over one INT-N base)")
    bad = meta_mismatch(got, meta)
    if bad:
        raise ValueError(f"checkpoint {path!r} was not trained against the "
                         f"served model: {'; '.join(bad)}")
    tree = checkpoint.load_pytree(path)
    if "t" not in tree:
        raise ValueError(f"checkpoint {path!r} holds no adapters (no 't' "
                         f"entry): not written by repro_torch.launch.train")
    trained = checkpoint.conform(tree["t"], schemes.trainable_tensors(params),
                                 path)

    def one(mpath, lp):
        if lp.scheme != "qalora":
            return lp
        name = mpath.replace("/", ".")
        ab = {pname.rsplit(".", 1)[-1]: trained[f"{name}.{pname}"]
              for pname, _ in lp.named_parameters()}
        return schemes.LinearParams(
            {"q": schemes.quantized_base(lp), "ad": QALoRAParams(**ab)},
            scheme="qalora", policy=lp.policy)
    return schemes.map_linears(params, one)


def is_demo(src: str) -> bool:
    return src.startswith("demo:")


def build_store(params, specs, meta=None):
    """An :class:`AdapterStore` over ``params`` (merged on entry) with one
    tenant per ``name=<source>`` spec: ``demo:<seed>`` (:func:`demo_tenant`)
    or a trainer's checkpoint (:func:`checkpoint_tenant`, which ``meta``
    checks).  Returns (store, names)."""
    from repro_torch.serving import AdapterStore
    store = AdapterStore(params, capacity=max(4, len(specs)))
    names = []
    for spec in specs:
        name, eq, src = spec.partition("=")
        if not eq or not name or not src:
            raise ValueError(f"--adapters entry {spec!r} is not name=source")
        if is_demo(src):
            tree = demo_tenant(params, int(src[len("demo:"):] or "0"))
        else:
            tree = checkpoint_tenant(params, src, meta)
        store.register(name, tree)
        names.append(name)
    return store, names


def build_model(cfg, device, seed: int = 0, bump: bool = True):
    """The served model: random init from ``seed`` on ``device``, adapters
    nudged by +0.01 (unless ``bump`` is False: then the adapters stay as
    initialised, B = 0, and the merge is the bare base, as a trainer
    starts from it), then merged.  Returns (lm, adapter params, merged
    params); the two share their codes and scales."""
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init(gen, device)
    if bump:
        params = bump_adapters(params)
    return lm, params, merge_model(params)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_graph_generator(lm, params, batch_shape, gen_len: int,
                         max_len: int, cache_dtype=torch.float32,
                         device="cuda", eager: bool = False):
    """Build the static serve path ONCE for a prompt shape (the counterpart
    of ``make_scan_generator``): a full-capacity decode cache and the
    :class:`~repro_torch.runtime.graphs.StepGraphs` of its decode step,
    both kept for every call.  Returns ``run(prompts) -> (tokens
    [B, gen_len] numpy, timings)``; ``run.graphs`` is the step's graph
    cache and ``run.budgets`` its capture budget, declared to the active
    :class:`~repro_torch.runtime.compile_guard.CompileGuard` if any when
    the step is captured (the eager and CPU routes capture nothing).

    Each call prefills the prompts as one batch (eagerly), embeds the
    prefill cache into the decode cache in place and decodes greedily with
    :meth:`~repro_torch.models.lm.LM.generate`: on CUDA one replay of the
    captured decode step a token (the first call captures it), or, with
    ``eager=True``, the same step run op by op (the timing and equivalence
    reference, ``--loop``)."""
    import weakref
    from repro_torch.runtime import compile_guard
    from repro_torch.runtime.graphs import StepGraphs, captures
    b = batch_shape[0]
    cache = lm.init_cache(b, max_len, dtype=cache_dtype, device=device)
    graphs = StepGraphs("serve.decode", device, eager=eager)

    def run(prompts):
        if tuple(prompts.shape) != tuple(batch_shape):
            raise ValueError(f"prompts {tuple(prompts.shape)}: this "
                             f"generator serves {tuple(batch_shape)}")
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, pre = lm.prefill(params, {"tokens": toks})
        lm.merge_prefill_cache(pre, cache)
        _sync(device)
        t1 = time.perf_counter()
        out, _ = lm.generate(params, cache, logits, gen_len, graphs=graphs)
        out = out.cpu().numpy()
        t2 = time.perf_counter()
        guard = compile_guard.current()
        if guard is not None:
            guard.check()
        return out, {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                     "total_s": t2 - t0}

    # one decode step, captured once for the generator's life
    run.graphs, run.budgets = graphs, {graphs.name: 1}
    guard = compile_guard.current()
    if guard is not None and graphs.capture is not None:
        owner = f"generator-{id(run)}"
        weakref.finalize(run, guard.release_owner, owner)
        guard.declare_jit(graphs.name, captures(graphs.name), 1,
                          owner=owner)
    return run


def generate(lm, params, prompts, gen_len: int, max_len: int,
             cache_dtype=torch.float32, device="cuda"):
    """One-shot prefill + greedy decode (see :func:`make_graph_generator`;
    the counterpart of ``generate_scan``).  Returns (tokens [B, gen_len]
    numpy, timings)."""
    return make_graph_generator(lm, params, prompts.shape, gen_len, max_len,
                                cache_dtype, device)(prompts)


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
    and max|logits| of each.

    A gqa_moe model is compared token by token over the tokens whose
    routing agreed (:func:`compare_routed`): the two models differ by
    rounding, which may flip a token's top-k choice where two router
    probabilities nearly tie, and a flipped token's logits move by far
    more than rounding.  Its prefill is compared at every position."""
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    nxt = lm.prefill(merged, {"tokens": toks})[0].argmax(-1).to(torch.int32)
    routed = lm.cfg.family == "gqa_moe"
    a, m = (_two_steps(lm, p, toks, nxt, max_len, cache_dtype, device,
                       routed) for p in (params, merged))
    if not routed:
        return {ph: _compare(a[ph], m[ph]) for ph in a}
    out = {}
    for ph in ("prefill", "decode"):
        same = routing_agreement(a["routes"][ph], m["routes"][ph])
        out[ph] = compare_routed(a[ph], m[ph], same)
    return out


def _two_steps(lm, params, toks, nxt, max_len: int, cache_dtype, device,
               routed: bool = False):
    """Prefill logits of ``toks``, then the logits of one decode step on
    the tokens ``nxt`` [B].  ``routed``: the prefill's logits at every
    position, and each pass's routing under ``"routes"``."""
    from repro_torch.models.moe import record_routing
    with record_routing() as pre_routes:
        logits, pre = (lm.prefill_all if routed else lm.prefill)(
            params, {"tokens": toks})
    cache = lm.merge_prefill_cache(
        pre, lm.init_cache(toks.shape[0], max_len, dtype=cache_dtype,
                           device=device))
    with record_routing() as step_routes:
        step = lm.decode_step(params, cache, nxt[:, None])[0]
    out = {"prefill": logits, "decode": step}
    if routed:
        out["routes"] = {"prefill": pre_routes, "decode": step_routes}
    return out


def _compare(got, ref):
    """max|got - ref|, max|ref|, their ratio ``rel``, and got's argmax."""
    diff, top = float((got - ref).abs().max()), float(ref.abs().max())
    return {"max_abs_diff": diff, "max_abs_logit": top,
            "rel": diff / max(top, 1e-30), "argmax": got.argmax(-1).tolist()}


def routing_agreement(routes_a, routes_b):
    """[L, B, S] bool: token (b, s) was routed alike at layer l by two runs
    (the ``record_routing`` lists of one forward each): the same experts
    kept and the same dropped, in any order of the top-k."""
    same = []
    for ra, rb in zip(routes_a, routes_b, strict=True):
        (ia, oa), (ib, ob) = (r["idx"].sort(dim=-1) for r in (ra, rb))
        ka, kb = ra["keep"].gather(-1, oa), rb["keep"].gather(-1, ob)
        same.append(((ia == ib) & (ka == kb)).all(dim=-1))
    return torch.stack(same)


def compare_routed(got, ref, same):
    """:func:`_compare` over the tokens whose routing agreed at every
    layer.  ``got``/``ref``: logits [B, S, V] or [B, V]; ``same``:
    :func:`routing_agreement`, [L, B, S] (S = 1 for [B, V] logits).
    Adds the share of (token, layer) pairs that flipped, the tokens and
    the agreeing tokens, and the largest gap on a flipped token over
    max|ref| (None when none flipped)."""
    agree = same.all(dim=0).reshape(got.shape[:-1])
    err = (got - ref).abs().amax(dim=-1)
    top = float(ref.abs().max())
    ok = float(err[agree].max()) if bool(agree.any()) else 0.0
    bad = float(err[~agree].max()) if not bool(agree.all()) else None
    last = got[:, -1] if got.dim() == 3 else got
    return {"max_abs_diff": ok, "max_abs_logit": top,
            "rel": ok / max(top, 1e-30), "argmax": last.argmax(-1).tolist(),
            "tokens": agree.numel(), "agreeing_tokens": int(agree.sum()),
            "flip_share": float(1.0 - same.float().mean()),
            "max_flipped_rel": None if bad is None else bad / max(top, 1e-30)}


NULL_TENANT = "<null>"


def tenant_check(lm, store, tenants, prompts, max_len: int,
                 cache_dtype=torch.float32, device="cuda"):
    """Slot-routed trees against merged trees, at prefill (the tiled
    kernel plus the bank delta) and one decode step (the slot GEMV) on the
    same prompts; the decode step feeds every tree the base model's greedy
    token.  For each tenant and the null adapter (key ``NULL_TENANT``), a
    tree with every row bound to it, against its own merged tree and the
    next one's (a gather that serves the right tenant is nearer its own);
    then one tree whose rows cycle the tenants and the null adapter, row i
    against row i of its tenant's merged tree and of the next one's.
    Returns ({tenant: own check}, {tenant: check against the next
    tenant}, mixed check)."""
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    b = toks.shape[0]
    names = [*tenants, None]
    nxt = lm.prefill(store.base, {"tokens": toks})[0].argmax(-1) \
        .to(torch.int32)

    def run(tree):
        return _two_steps(lm, tree, toks, nxt, max_len, cache_dtype, device)
    merged = [run(store.merged(name)) for name in names]
    own, other = {}, {}
    for i, name in enumerate(names):
        key = NULL_TENANT if name is None else name
        routed = run(store.with_slot_ids(
            np.full(b, store.resolve(name), np.int32)))
        own[key], other[key] = (
            {ph: _compare(routed[ph], ref[ph]) for ph in routed}
            for ref in (merged[i], merged[(i + 1) % len(names)]))
    which = [i % len(names) for i in range(b)]
    routed = run(store.with_slot_ids(np.asarray(
        [store.resolve(names[w]) for w in which], np.int32)))
    mixed = {"tenants": [NULL_TENANT if names[w] is None else names[w]
                         for w in which]}
    for ph in routed:
        mixed[ph] = {key: [_compare(routed[ph][r], merged[
            (w + step) % len(names)][ph][r])["rel"]
            for r, w in enumerate(which)]
            for key, step in (("rel", 0), ("next_rel", 1))}
    return own, other, mixed


def serve_continuous(lm, params, prompts, gen_len: int, max_len: int, *,
                     slots: int, prefill_chunk: int, decode_burst: int,
                     store, who, device="cuda", eager: bool = False,
                     **modes):
    """Serve every prompt through one :class:`ContinuousEngine` (request i
    bound to adapter ``who(i)``; ``eager`` selects the engine's eager
    steps; ``modes`` are the engine's paging and speculation arguments).
    Returns (tokens [B, gen_len] numpy, the engine, the kernel launch
    counts when the engine drained)."""
    from repro_torch import kernels
    from repro_torch.serving import ContinuousEngine
    eng = ContinuousEngine(lm, params, n_slots=slots, max_len=max_len,
                           prefill_chunk=prefill_chunk,
                           decode_burst=decode_burst, adapters=store,
                           eager=eager, **modes)
    rids = [eng.submit(p, gen_len, adapter_id=who(i))
            for i, p in enumerate(prompts)]
    outputs = eng.run()
    _sync(device)
    gen = np.asarray([outputs[r] for r in rids], dtype=np.int32)
    return gen, eng, kernels.launches()


def serve_frontend(args, lm, params, prompts, max_len: int, result: dict, *,
                   slots: int, prefill_chunk: int, decode_burst: int,
                   store, who, device="cuda", eager: bool = False, **modes):
    """``--engine frontend``: every prompt submitted to one
    :class:`ServingFrontend` (request i bound to adapter ``who(i)``; the
    queue cap, deadlines and ``--inject-faults``' injector from ``args``;
    ``modes`` the engine's paging and speculation arguments), driven on
    this thread inside a ``PreemptionGuard`` until it drains.  Prints the
    status counts, the recoveries and the SLO line, and records them in
    ``result``.  Returns (each request's committed tokens, the engine, the
    launch counts when it drained, the engine's counters summed over its
    recoveries)."""
    from repro_torch import kernels
    from repro_torch.runtime.fault import FaultInjector, PreemptionGuard
    from repro_torch.serving import ServingFrontend, slo_summary
    injector = None
    if args.inject_faults:
        # one crash once decode is under way, and some straggler latency
        injector = FaultInjector(seed=0, crash_steps=(5,), p_straggle=0.1,
                                 straggle_s=0.01)

    def ms(v):
        return v / 1e3 if v and v > 0 else None
    with PreemptionGuard() as guard:
        fe = ServingFrontend(
            lm, params, n_slots=slots, max_len=max_len,
            prefill_chunk=prefill_chunk, decode_burst=decode_burst,
            queue_cap=args.queue_cap,
            default_deadline_s=ms(args.deadline_ms),
            default_ttft_deadline_s=ms(args.ttft_deadline_ms),
            injector=injector, guard=guard, adapters=store, eager=eager,
            **modes)
        tickets = [fe.submit(p, args.gen_len, adapter_id=who(i))
                   for i, p in enumerate(prompts)]
        fe.run_until_drained()
        _sync(device)
    counts = kernels.launches()
    statuses = fe.status_counts()
    slo = slo_summary(fe)
    est = fe.engine_stats
    result.update(statuses=statuses, recoveries=fe.n_recoveries,
                  fault_log=[e for _, e in fe.fault_log],
                  injector_log=list(injector.log) if injector else [],
                  slo=slo,
                  ticket_status=[t.status.name for t in tickets],
                  ticket_errors=[t.error for t in tickets])
    print(f"[serve] frontend: {statuses} ({fe.n_recoveries} recoveries, "
          f"occupancy {est.occupancy:.0%}, {est.dispatches} dispatches)")
    print(f"[serve] SLO: ttft p50/p95 {slo['ttft_p50_s'] * 1e3:.0f}/"
          f"{slo['ttft_p95_s'] * 1e3:.0f}ms, tpot p50 "
          f"{slo['tpot_p50_s'] * 1e3:.1f}ms, goodput "
          f"{slo['goodput_tok_s']:.1f} tok/s, timeout rate "
          f"{slo['timeout_rate']:.0%}, reject rate {slo['reject_rate']:.0%}")
    for t in tickets:
        if t.error:
            print(f"[serve]   rid {t.rid}: {t.status.name} - {t.error}")
    return [list(t.tokens) for t in tickets], fe.engine, counts, est


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
    ap.add_argument("--loop", action="store_true",
                    help="run every serve step op by op (the eager "
                         "reference for timing and equivalence) instead of "
                         "replaying its captured CUDA graph")
    ap.add_argument("--policy", default="",
                    help='per-layer policy rules, e.g. "*=int4,*/attn/wo=int8"')
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--engine", choices=("static", "continuous", "frontend"),
                    default="static")
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous engine slots (default min(4, requests))")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--decode-burst", type=int, default=None,
                    help="continuous engine decode steps per burst (clamped "
                         "down to a power of two; default 8, and 1 under "
                         "--speculate)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="continuous engine: page the KV cache into pages "
                         "of this many tokens, pooled across slots with "
                         "prefix reuse (0 = contiguous per-slot slabs)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="paged pool size, the null page included (0 = the "
                         "contiguous capacity, slots x ceil(max_len / "
                         "page_size) + 1; fewer oversubscribe the pool and "
                         "admission backs off while it is dry)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="continuous engine: draft this many tokens a slot "
                         "per decode dispatch and verify them in one ragged "
                         "step (greedy: the streams of plain decode); not "
                         "with --decode-burst > 1")
    ap.add_argument("--draft-policy", default="",
                    help="the drafter for --speculate: a policy spec that "
                         "re-quantizes the merged model (default "
                         "'*=intq8')")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="frontend: submits past this many waiting "
                         "requests are REJECTED with the queue depth in the "
                         "error")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="frontend: per-request total deadline (0 = none); "
                         "an expired slot is evicted like EOS")
    ap.add_argument("--ttft-deadline-ms", type=float, default=0,
                    help="frontend: per-request time-to-first-token "
                         "deadline (0 = none)")
    ap.add_argument("--inject-faults", action="store_true",
                    help="frontend: a seeded FaultInjector (one engine "
                         "crash at dispatch 5 and straggler latency); "
                         "recovery replays in-flight requests token for "
                         "token")
    ap.add_argument("--adapters", default="",
                    help="tenants name=<source>,... (continuous engine or "
                         "frontend); a "
                         "source is demo:<seed> (the served adapters plus "
                         "seeded noise) or a checkpoint written by "
                         "repro_torch.launch.train (its --ckpt-dir, or one "
                         "step's directory), served over the base it was "
                         "trained on: give the trainer's --seed; a "
                         "checkpoint of another model, policy, seed or "
                         "device is refused, and so is a list that mixes "
                         "demo and checkpoint sources")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's random init; the server and "
                         "repro_torch.launch.train build the same base from "
                         "the same --seed on the same device")
    args = ap.parse_args(argv)
    slotted = args.engine in ("continuous", "frontend")
    if args.adapters and not slotted:
        ap.error("--adapters needs --engine continuous|frontend (per-slot "
                 "adapters apply to slotted serving)")
    if slotted and args.gen_len < 1:
        ap.error(f"--engine {args.engine} needs --gen-len >= 1")
    if args.page_size and not slotted:
        ap.error("--page-size needs --engine continuous|frontend (the "
                 "static path has no slot scheduler to drive a page pool)")
    if args.speculate and not slotted:
        ap.error("--speculate needs --engine continuous|frontend (draft and "
                 "ragged verify run on the slot scheduler)")
    if args.inject_faults and args.engine != "frontend":
        ap.error("--inject-faults needs --engine frontend (only the "
                 "frontend recovers from an engine fault)")
    if args.speculate and args.decode_burst is not None \
            and args.decode_burst > 1:
        ap.error("--speculate is incompatible with --decode-burst > 1: the "
                 "one-step ragged verify IS the multi-token dispatch; drop "
                 "--decode-burst (it is 1 when speculating)")
    decode_burst = (1 if args.speculate else
                    8 if args.decode_burst is None else args.decode_burst)

    import repro_torch.configs as C
    from repro_torch.core.schemes import PolicyTree
    from repro_torch.models.lm import resolve_device

    device = resolve_device(args.device)
    cfg = C.reduced(args.arch) if args.reduced else C.get(args.arch)
    if args.policy:
        try:
            pol = PolicyTree.parse(args.policy, base=cfg.quant.default)
        except ValueError as e:
            ap.error(f"--policy: {e}")
        cfg = cfg.scaled(quant=pol)
    if cfg.family == "gqa_moe" and args.adapters:
        from repro_torch.serving.engine import MOE_TENANTS
        ap.error(f"--arch {args.arch} --adapters: {MOE_TENANTS}")
    specs = [s for s in args.adapters.split(",") if s]
    # a trained checkpoint is served over the base it was trained on, its
    # adapters as initialised; a demo tenant is a nudge of the nudged base,
    # so the two do not share a base
    trained = any(not is_demo(s.partition("=")[2]) for s in specs)
    if trained and any(is_demo(s.partition("=")[2]) for s in specs):
        ap.error("--adapters: demo and checkpoint sources do not mix (a "
                 "checkpoint is served over the base as initialised, demo "
                 "tenants over the nudged one); give one kind")
    t0 = time.perf_counter()
    lm, params, merged = build_model(cfg, device, seed=args.seed,
                                     bump=not trained)
    store, tenants = None, []
    if specs:
        from repro_torch.launch.train import train_meta
        meta = train_meta(cfg, params, args.seed, device) if trained else None
        try:
            store, tenants = build_store(params, specs, meta)
        except ValueError as e:
            ap.error(f"--adapters: {e}")
        merged = store.base
        print(f"[serve] adapter store: {store.n_adapters} tenants {tenants} "
              f"over one int{cfg.quant.default.bits} base (capacity "
              f"{store.capacity} + null adapter, banks "
              f"{store.bank_bytes / 1e6:.1f} MB)")
    _sync(device)
    init_s = time.perf_counter() - t0

    b = args.requests
    # an empty prompt still needs one token to condition on: feed BOS (=0)
    prompt_len = max(args.prompt_len, 1)
    # +speculate: the verify step writes up to k rows past the committed
    # stream before the rejected tail rolls back
    max_len = prompt_len + args.gen_len + args.speculate
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(b, prompt_len)).astype(np.int32)
    if args.prompt_len == 0:
        prompts[:] = 0

    result = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "linears_per_layer": lm.layer_linears(),
              "device": str(device), "engine": args.engine,
              "path": ("graphs" if device.type == "cuda" and not args.loop
                       else "eager"), "requests": b,
              "prompt_len": prompt_len, "gen_len": args.gen_len,
              "init_s": init_s}
    if slotted:
        # requests cycle the tenants round-robin, with a null-adapter
        # request in the mix
        cycle = [*tenants, None]
        slots = args.slots or min(4, b)
        modes = dict(page_size=max(args.page_size, 0),
                     n_pages=args.n_pages or None, speculate=args.speculate,
                     drafter=(args.draft_policy or "*=intq8")
                     if args.speculate else None)
        run = dict(slots=slots, prefill_chunk=args.prefill_chunk,
                   decode_burst=decode_burst, store=store,
                   who=lambda i: cycle[i % len(cycle)], device=device,
                   eager=args.loop, **modes)
        try:
            if args.engine == "frontend":
                toks, eng, counts, st = serve_frontend(
                    args, lm, merged, prompts, max_len, result, **run)
            else:
                toks, eng, counts = serve_continuous(
                    lm, merged, prompts, args.gen_len, max_len, **run)
                st = eng.stats
        except (ValueError, NotImplementedError) as e:
            # a degenerate pool, a request the pool can never cover, a
            # drafter the port lacks, or adapters under speculation
            flags = [f for f, v in (("--page-size", args.page_size),
                                    ("--speculate", args.speculate)) if v]
            if not flags:
                raise
            ap.error(f"{' '.join(flags)}: {e}")
        graphs, budgets = eng.graphs, eng.budgets
        decode_steps = (st.model_steps
                        - args.prefill_chunk * st.ragged_dispatches)
        result.update(
            slots=slots, prefill_chunk=args.prefill_chunk,
            decode_burst=decode_burst, tenants=tenants,
            bank_bytes=store.bank_bytes if store else 0,
            total_s=st.seconds, ragged_s=st.ragged_seconds,
            burst_s=st.seconds - st.ragged_seconds,
            dispatches=st.dispatches, ragged_dispatches=st.ragged_dispatches,
            model_steps=st.model_steps, decode_steps=decode_steps,
            occupancy=st.occupancy, tokens_out=st.tokens_out,
            tok_s=st.tok_per_s, launches_engine=counts,
            decode_ms_per_step=((st.seconds - st.ragged_seconds) * 1e3
                                / max(decode_steps, 1)))
        extra = ""
        pt = eng.page_table
        if pt is not None:
            pt.check_invariants()
            result.update(page_size=args.page_size, n_pages=eng.n_pages,
                          reused_tokens_total=pt.reused_tokens_total,
                          alloc_backoffs=pt.alloc_backoffs,
                          peak_pages_used=pt.peak_used)
            extra += (f", pages of {args.page_size}: {pt.peak_used} of "
                      f"{pt.capacity} at peak, {pt.reused_tokens_total} "
                      f"prompt tokens reused, {pt.alloc_backoffs} backoffs")
        if args.speculate:
            result.update(speculate=args.speculate,
                          drafter=modes["drafter"],
                          proposed_tokens=st.proposed_tokens,
                          accepted_tokens=st.accepted_tokens,
                          acceptance_rate=st.acceptance_rate)
            extra += (f", speculate {args.speculate} with {modes['drafter']}"
                      f": acceptance {st.acceptance_rate:.0%}")
        print(f"[serve] {b} requests, {st.tokens_out} tokens in "
              f"{st.seconds:.3f}s ({st.tok_per_s:.1f} tok/s, {args.engine}, "
              f"{slots} slots, occupancy {st.occupancy:.0%}, "
              f"{st.dispatches} dispatches ({st.ragged_dispatches} ragged), "
              f"{len(tenants)}+null tenants{extra}, {result['path']}, "
              f"{device})")
    else:
        gen = make_graph_generator(lm, merged, prompts.shape, args.gen_len,
                                   max_len, device=device, eager=args.loop)
        toks, times = gen(prompts)
        graphs, budgets = {"decode": gen.graphs}, gen.budgets
        result.update(times)
        result["decode_ms_per_token"] = (times["decode_s"] * 1e3
                                         / max(args.gen_len - 1, 1))
        result["tok_s"] = b * toks.shape[1] / max(times["total_s"], 1e-9)
        print(f"[serve] {b} requests x {toks.shape[1]} tokens in "
              f"{times['total_s']:.3f}s ({result['tok_s']:.1f} tok/s, "
              f"prefill+decode, {result['path']}, {device})")
    # the step graphs, for callers that replay or profile them
    result["graphs"] = graphs
    result["captures"] = {g.name: [g._cache_size(), budgets[g.name]]
                          for g in graphs.values()}
    result["tokens"] = toks
    print(f"[serve] sample generation: "
          f"{np.asarray(toks[0][:8], np.int32)}; captures (count, budget): "
          f"{result['captures']}")

    if args.verify:
        # the adapter model against its merge, or each tenant's slot-routed
        # tree against its merged tree
        bound = merge_bound(cfg)
        result["merge_bound_rel"] = bound
        others = {}
        if store is None:
            result["merge_check"] = merge_check(lm, params, merged, prompts,
                                                max_len, device=device)
            checks = {"adapter model": result["merge_check"]}
        else:
            checks, others, mixed = tenant_check(lm, store, tenants, prompts,
                                                 max_len, device=device)
            result["tenant_check"] = checks
            result["tenant_cross_check"] = others
            result["mixed_check"] = mixed
            for phase in ("prefill", "decode"):
                own, far = mixed[phase]["rel"], mixed[phase]["next_rel"]
                print(f"[serve] mixed tenants {mixed['tenants']}, {phase}: "
                      f"row vs its tenant's merged tree up to {max(own):.2e} "
                      f"of max|logit|, vs the next tenant's from "
                      f"{min(far):.2e}")
                for r, (o, f) in enumerate(zip(own, far)):
                    if not (o <= bound and o < f):
                        raise AssertionError(
                            f"mixed row {r} ({mixed['tenants'][r]}) at "
                            f"{phase}: {o:.3e} of max|logit| from its "
                            f"tenant's merged tree (bound {bound}), "
                            f"{f:.3e} from the next tenant's")
        for name, check in checks.items():
            for phase, r in check.items():
                far = others[name][phase]["rel"] if name in others else None
                print(f"[serve] {name} vs merged, {phase}: max|diff| = "
                      f"{r['max_abs_diff']:.3e} ({r['rel']:.2e} of "
                      f"max|logit|, bound {bound:.0e}"
                      + (f"; over {r['agreeing_tokens']} of {r['tokens']} "
                         f"tokens routed alike, {r['flip_share']:.2%} of "
                         f"(token, layer) routings flipped"
                         if "flip_share" in r else "")
                      + (f"; vs the next tenant's merged tree {far:.2e}"
                         if far is not None else "")
                      + f"; argmax {r['argmax'][:4]})")
                if not r["rel"] <= bound:
                    raise AssertionError(
                        f"{name} diverged from its merged tree at {phase}: "
                        f"{r['rel']:.3e} > {bound}")
                if far is not None and not r["rel"] < far:
                    raise AssertionError(
                        f"{name} at {phase} is no nearer its own merged tree "
                        f"({r['rel']:.3e}) than the next tenant's ({far:.3e})")
    print("[serve] done")
    return result


if __name__ == "__main__":
    main()
