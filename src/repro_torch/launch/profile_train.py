"""Where a QA-LoRA train step's time goes on the card: ``torch.profiler``
over one step of ``repro_torch.launch.train``'s model (after one step
without the profiler), at the settings of ``chip_smoke.py``'s train phase.

    python -m repro_torch.launch.profile_train --arch llama7b-proxy \\
        --seq-len 256 --global-batch 16 --out chiprun_out/profile

Prints one JSON line: the unprofiled step's wall ms, then, for the
profiled step, wall ms, device-busy ms, the device's idle share, device
time by kind and the kernels that took the most of it (see
``profile_serve``), and the host operations that took the most host time;
writes the profiler tables and a Chrome trace under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama7b-proxy")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--dataset", default="alpaca")
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    from repro_torch.launch import train
    from repro_torch.launch.profile_serve import _profile
    targs = train.build_parser().parse_args(
        ["--arch", args.arch, "--seq-len", str(args.seq_len),
         "--global-batch", str(args.global_batch), "--dataset", args.dataset,
         "--device", "cuda"])
    st = train.setup(targs)

    def step():
        toks, labs = st.stream.next_batch()
        batch = {"tokens": torch.as_tensor(toks).to(st.device),
                 "labels": torch.as_tensor(labs).to(st.device)}
        return float(st.step_fn(st.params, st.opt_state, batch)["loss"])

    step()              # warm-up: first-call set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = _profile(step, args.out, "train_step")
    out = {"phase": "train_step", "arch": st.cfg.name,
           "batch": [args.global_batch, args.seq_len],
           "device": torch.cuda.get_device_name(0),
           "unprofiled_wall_ms": plain_ms, **res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
