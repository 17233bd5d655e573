"""End-to-end QA-LoRA fine-tuning driver (counterpart of
``repro.launch.train``).

config -> model (quantized init from ``--seed``) -> adapter-only AdamW ->
train step -> data stream -> async checkpoints -> restartable loop
(straggler detection, a final save on SIGTERM, O(1) data skip-ahead).  On
the card every ``qalora`` linear's forward is kernel 3 with its rank
projection (a gqa_moe model's experts each at its capacity buffer's
rows, the loss with the router's aux term); the backward is plain
PyTorch.  ``--mode lora`` and ``--mode qlora`` train the baselines'
adapters (plain PyTorch products over a float or NF4 base); ``--mode fp``
declares no trainable tensor and is refused.

It resumes from the newest complete checkpoint in ``--ckpt-dir`` (refusing
one written for another model, seed or device), and writes the frozen base
there once.  ``repro_torch.launch.serve --adapters name=<ckpt-dir>``
serves the result over the same base.

    python -m repro_torch.launch.train --arch llama7b-proxy --steps 4 \\
        --seq-len 256 --global-batch 16 --ckpt-dir build/ckpt --ckpt-every 2
    python -m repro_torch.launch.train --arch gemma3-1b --reduced \\
        --device cpu --steps 20 --seq-len 64 --global-batch 8
    python -m repro_torch.launch.train --arch mixtral-8x22b --reduced \\
        --device cpu --steps 4 --seq-len 32 --global-batch 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from types import SimpleNamespace

import torch

NOT_PORTED = "not yet ported (see ROADMAP.md)"
SEED_HELP = ("seed of the model's random init; the trainer and "
             "repro_torch.launch.serve build the same base from the same "
             "--seed on the same device")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama7b-proxy")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="train the first N layers of the config at its "
                         "widths (0 = all); a depth cut for smoke runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--dataset", default="alpaca")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=0,
                    help="0 = config default")
    ap.add_argument("--mode", default="qalora",
                    choices=["qalora", "qlora", "lora", "fp"])
    ap.add_argument("--policy", default="",
                    help='per-layer policy rules overriding --mode, e.g. '
                         '"*=int4,*/attn/wo=int8,lm_head=fp"')
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="cpu", choices=["cpu", "pod", "multipod"],
                    help="cpu = one device (the card, or the CPU with "
                         "--device cpu)")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="cross-pod int8 adapter sync cadence (multipod)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help=SEED_HELP)
    return ap


def train_meta(cfg, params, seed: int, device) -> dict:
    """What a checkpoint's adapters were trained against: the model's
    shape, the seed and device type its base was built from, and every
    adapter linear's policy: (bits, group size, rank, s, dtype) for a
    ``qalora`` linear, (scheme, rank, s, dtype) for ``lora`` and
    ``qlora``."""
    from repro_torch.core import schemes
    policy = {}
    for name, lp in params.named_modules():
        if not schemes.is_linear(lp) or not schemes.get_scheme(
                lp.scheme).trainable_paths(lp.data):
            continue
        ad = schemes.adapter_params(lp)
        p = lp.policy
        tail = [int(ad.a.shape[1]), p.s, str(ad.a.dtype).replace("torch.", "")]
        policy[name] = ([p.bits, p.group_size] if lp.scheme == "qalora"
                        else [lp.scheme]) + tail
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "seed": int(seed), "device": torch.device(device).type,
            "policy": policy}


def meta_mismatch(got: dict, want: dict) -> list:
    """The fields where a checkpoint's :func:`train_meta` differs from the
    model's (for the policy, the first linears that differ)."""
    out = []
    for key in sorted(set(got) | set(want)):
        if key == "policy":
            g, w = got.get(key, {}), want.get(key, {})
            bad = sorted(k for k in set(g) | set(w) if g.get(k) != w.get(k))
            out += [f"policy at {k}: checkpoint {g.get(k)}, model {w.get(k)}"
                    for k in bad[:3]]
        elif got.get(key) != want.get(key):
            out.append(f"{key}: checkpoint {got.get(key)!r}, model "
                       f"{want.get(key)!r}")
    return out


def build_config(args):
    """The config the flags ask for; raises on what is not ported."""
    import repro_torch.configs as C
    from repro_torch.core.schemes import PolicyTree
    if args.mesh != "cpu":
        raise NotImplementedError(f"--mesh {args.mesh}: {NOT_PORTED}; the "
                                  f"port trains on one device")
    if args.sync_every:
        raise NotImplementedError(f"--sync-every {args.sync_every}: "
                                  f"{NOT_PORTED} (cross-pod adapter sync)")
    cfg = C.reduced(args.arch) if args.reduced else C.get(args.arch)
    if args.n_layers:
        cfg = cfg.scaled(n_layers=args.n_layers)
    q = dataclasses.replace(
        cfg.quant.default, mode=args.mode, bits=args.bits,
        **({"group_size": args.group_size} if args.group_size else {}))
    if args.policy:
        q = PolicyTree.parse(args.policy, base=q)
    return cfg.scaled(quant=q)


def setup(args, params=None) -> SimpleNamespace:
    """Model, optimizer state, data stream and checkpoint manager, resumed
    from the newest complete checkpoint in ``--ckpt-dir`` if there is
    one (the base is written there once).  ``params`` trains a given model
    of the config (e.g. :func:`repro_torch.core.schemes.convert_tree` of a
    float base) in place of the one drawn from ``--seed``."""
    from repro_torch.checkpoint import CheckpointManager, read_meta
    from repro_torch.data import make_stream
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.models.lm import LM, resolve_device
    from repro_torch.optim import (AdamWConfig, adamw_init, count_params,
                                   split_params)

    device = resolve_device(args.device)
    cfg = build_config(args)
    lm = LM(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init(gen, device)
    trainable, frozen = split_params(params)
    if not trainable:
        # e.g. --mode fp: the reference's mask is all False there and its
        # optimizer sees an empty tree, a run that moves nothing
        raise NotImplementedError(
            f"--mode {args.mode}{' --policy ' + args.policy if args.policy else ''}"
            f" declares no trainable tensor (an fp linear has no adapter), "
            f"so nothing would train; use qalora, lora or qlora")
    opt_state = adamw_init(trainable)
    print(f"[train] arch={cfg.name} mode={args.mode} bits={args.bits} "
          f"trainable={count_params(trainable):,} "
          f"frozen={count_params(frozen):,} device={device}")
    opt_cfg = AdamWConfig(lr=args.lr, schedule="constant")
    stream = make_stream(args.dataset, vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch)
    meta = train_meta(cfg, params, args.seed, device)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        bad = meta_mismatch(read_meta(ckpt.step_dir(start)), meta)
        if bad:
            raise ValueError(f"checkpoint step {start} in {args.ckpt_dir!r} "
                             f"was written for another model: "
                             f"{'; '.join(bad)}")
        state = ckpt.restore(start, {"t": trainable, "o": opt_state})
        with torch.no_grad():
            for name, t in state["t"].items():
                trainable[name].copy_(t)
            for key in ("mu", "nu"):
                for name, t in state["o"][key].items():
                    opt_state[key][name].copy_(t)
            opt_state["step"].copy_(state["o"]["step"])
        stream.skip_to(start)
        print(f"[train] resumed from step {start}")
    base_s = None
    if ckpt:
        t0 = time.perf_counter()
        ckpt.save_base(frozen, meta)
        base_s = time.perf_counter() - t0
    return SimpleNamespace(cfg=cfg, lm=lm, params=params, trainable=trainable,
                           opt_state=opt_state, opt_cfg=opt_cfg,
                           stream=stream, ckpt=ckpt, start=start, meta=meta,
                           device=device, base_save_s=base_s,
                           step_fn=make_train_fn(lm, opt_cfg))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(st: SimpleNamespace, args) -> dict:
    """Runs the restartable loop from ``st.start`` to ``--steps``.  Returns
    the per-step losses (and their xent and aux terms), grad norms, wall
    times and kernel launches, and the end-to-end numbers (median step
    wall after the first step, tokens/s, peak device memory)."""
    from repro_torch import kernels
    from repro_torch.runtime import PreemptionGuard, RestartableLoop

    dev = st.device
    rec = {"step": [], "loss": [], "xent": [], "aux": [], "grad_norm": [],
           "step_ms": [], "launches": [], "ckpt_snapshot_ms": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def save_cb(step):
        if st.ckpt:
            t0 = time.perf_counter()
            st.ckpt.save(step, {"t": st.trainable, "o": st.opt_state},
                         st.meta)
            rec["ckpt_snapshot_ms"].append((time.perf_counter() - t0) * 1e3)

    def body(step):
        _sync(dev)
        before = kernels.launches()
        t0 = time.perf_counter()
        toks, labs = st.stream.next_batch()
        batch = {"tokens": torch.as_tensor(toks).to(dev),
                 "labels": torch.as_tensor(labs).to(dev)}
        metrics = st.step_fn(st.params, st.opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step's last kernel
        ms = (time.perf_counter() - t0) * 1e3
        gnorm = float(metrics["grad_norm"])
        after = kernels.launches()
        rec["launches"].append({k: after[k] - before[k] for k in after})
        rec["step"].append(step)
        rec["loss"].append(loss)
        rec["xent"].append(float(metrics["xent"]))
        rec["aux"].append(float(metrics["aux"]))
        rec["grad_norm"].append(gnorm)
        rec["step_ms"].append(ms)
        if step % args.log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} gnorm={gnorm:.3f}")
        return {"loss": loss}

    with PreemptionGuard() as guard:
        loop = RestartableLoop(args.steps, args.ckpt_every, save_cb,
                               start_step=st.start, guard=guard)
        t0 = time.time()
        end = loop.run(body)
        dt = time.time() - t0
    drain_s = None
    if st.ckpt:
        t1 = time.perf_counter()
        st.ckpt.wait()
        drain_s = time.perf_counter() - t1
        st.ckpt.close()
    print(f"[train] finished at step {end} "
          f"({dt / max(end - st.start, 1):.3f}s/step, "
          f"{len(loop.stragglers)} straggler steps)")
    steady = rec["step_ms"][1:] or rec["step_ms"]
    median = statistics.median(steady) if steady else None
    tokens = args.global_batch * args.seq_len
    summary = {
        "arch": st.cfg.name, "n_layers": st.cfg.n_layers,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "start": st.start, "end": end, "tokens_per_step": tokens,
        "step_ms_median": median,
        "tokens_per_s": tokens / (median / 1e3) if median else None,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "loss": rec["loss"], "xent": rec["xent"], "aux": rec["aux"],
        "grad_norm": rec["grad_norm"],
        "step_ms": rec["step_ms"], "stragglers": len(loop.stragglers),
        # checkpoints: the base written once (setup), each step's snapshot
        # to host memory on this thread, and the writer's tail after the
        # loop
        "base_save_s": st.base_save_s,
        "ckpt_snapshot_ms": rec["ckpt_snapshot_ms"],
        "ckpt_drain_s": drain_s}
    print(json.dumps({"train": summary}))
    return {**summary, "steps": rec["step"], "launches": rec["launches"],
            "state": st}


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        st = setup(args)
    except NotImplementedError as e:
        ap.error(str(e))
    return run(st, args)


if __name__ == "__main__":
    main()
