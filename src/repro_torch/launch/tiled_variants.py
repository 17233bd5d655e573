"""Variants of the tiled dequant-matmul kernel (``csrc/tiled.cuh``), built
side by side and timed per llama7b-proxy layer on the card.

    python -m repro_torch.launch.tiled_variants
    python -m repro_torch.launch.tiled_variants --variants committed,no_dequant

Each variant is the committed source with a few lines replaced: ablations
that drop one part of a K step (the dequant, the tensor-core products,
the x copies or the weight copies; their outputs are wrong and not
checked), the WMMA fragment loads through generic pointers, and other
stage counts and tiles (checked against the plain version, as the ratio
of max|y - plain| to 2**-6 * max|plain|).  Kernel 1 (``qmatmul_bf16``)
at int4 g32 with bf16 scales, timed with CUDA events over weight copies
that keep the 50 MB L2 cold, at M = 512 and 256, in two rounds taken in
turn.  Prints one JSON line per variant and round, and the ptxas
registers and spills of the served instantiation; writes them to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import torch

from ..core import quant
from ..kernels import build
from ..kernels.qmatmul import block_k, qmatmul_plain

ROUNDS = 2  # every variant timed once a round, the rounds in turn
# one layer's linears: (K, N, count)
SHAPES = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
ENTRY = "tiled_kernelILi4E13__nv_bfloat16Lb0E"
MMA = ("for (int j = 0; j < kFN; ++j) wmma::mma_sync(c[i][j], fa[i], "
       "fb[j], c[i][j]);")
ONE_BLOCK = {"__launch_bounds__(kThreads, 2)": "__launch_bounds__(kThreads, 1)"}
# name: ({committed text: replacement}, checked against the plain version)
VARIANTS = {
    "committed": ({}, True),
    "no_dequant": ({"  dequant_stage(0, ws0);": "",
                    "    if (kt + 1 < nk)\n      dequant_stage(":
                    "    if (false)\n      dequant_stage("}, False),
    "no_mma": ({MMA: "for (int j = 0; j < kFN; ++j) {}"}, False),
    "no_x_copies": ({"        if (q < nxv) {": "        if (false) {"}, False),
    "no_w_copies": ({"e < QR * kCQ; e += kThreads": "e < 0; e += kThreads",
                     "e < gpt * SCPR; e += kThreads": "e < 0; e += kThreads"},
                    False),
    "generic_wmma_loads": ({
        "        load_a(fa[i], xs + (wm * kFM + i) * 16 * LDX + kk, LDX);":
        "        wmma::load_matrix_sync(fa[i], xs + (wm * kFM + i) * 16 * "
        "LDX + kk, LDX);",
        "        load_b(fb[j], ws + kk * kLDW + (wn * kFN + j) * 16, kLDW);":
        "        wmma::load_matrix_sync(fb[j], ws + kk * kLDW + (wn * kFN + j)"
        " * 16, kLDW);"}, True),
    "stages3": ({"constexpr int kStages = 4;": "constexpr int kStages = 3;"},
                True),
    "stages6": ({"constexpr int kStages = 4;": "constexpr int kStages = 6;",
                 **ONE_BLOCK}, True),
    "tile128x128": ({"constexpr int kTM = 128, kTN = 64,":
                     "constexpr int kTM = 128, kTN = 128,", **ONE_BLOCK},
                    True),
    "tile64x64": ({"constexpr int kTM = 128, kTN = 64, kThreads = 256;":
                   "constexpr int kTM = 64, kTN = 64, kThreads = 128;",
                   "__launch_bounds__(kThreads, 2)":
                   "__launch_bounds__(kThreads, 4)"}, True),
}


def _build(names, root):
    """Compile each variant's qmatmul.cu in parallel; returns {name:
    (entry or None, ptxas numbers)}."""
    base = (build.CSRC / "tiled.cuh").read_text()
    procs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name][0].items():
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in tiled.cuh")
            src = src.replace(old, new)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "tiled.cuh"), "w") as f:
            f.write(src)
        for f in ("dequant.cuh", "qmatmul.cu"):
            with open(os.path.join(d, f), "w") as out:
                out.write((build.CSRC / f).read_text())
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", d,
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "qmatmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas = build.ptxas_report(log, ENTRY) or {}
        fn = None
        if proc.returncode == 0:
            fn = ctypes.CDLL(os.path.join(root, name, "lib.so")).qmatmul_bf16
            fn.argtypes = build.SIGNATURES["qmatmul"]["qmatmul_bf16"]
            fn.restype = ctypes.c_int
        else:
            ptxas["build_error"] = log[-2000:]
        out[name] = (fn, ptxas)
    return out


def _weights(gen, l2_bytes=50e6):
    cases = {}
    for k, n, _ in SHAPES:
        per_copy = k * n // 2 + 4 * (k // 32) * n
        cases[(k, n)] = [
            quant.quantize(torch.randn((k, n), generator=gen, device="cuda")
                           / math.sqrt(k), 4, 32, scale_dtype=torch.bfloat16)
            for _ in range(max(2, math.ceil(2.5 * l2_bytes / per_copy)))]
    return cases


def _call(fn, x, qt, y):
    m, k = x.shape
    rc = fn(x.data_ptr(), qt.qweight.data_ptr(), qt.scale.data_ptr(),
            qt.zero.data_ptr(), y.data_ptr(), m, k, qt.qweight.shape[1], 32,
            block_k(32), 4, 0, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "qmatmul_bf16 (variant)")


def _time_layer(fn, gen, cases, m, check, iters=30):
    row, layer = {}, 0.0
    for k, n, count in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        qts = cases[(k, n)]
        if check:
            _call(fn, x, qts[0], y)
            ref = qmatmul_plain(x, qts[0].qweight, qts[0].scale, qts[0].zero,
                                bits=4, group_size=32).float()
            row[f"err_over_tol_{k}x{n}"] = (
                (y.float() - ref).abs().max().item()
                / (2.0 ** -6 * ref.abs().max().item()))
        for qt in qts[:2]:
            _call(fn, x, qt, y)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            _call(fn, x, qts[i % len(qts)], y)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        row[f"ms_{k}x{n}"] = ms
        layer += ms * count
    row["layer_ms"] = layer
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="chiprun_out/tiled_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tiled_variants needs an NVIDIA card")
    names = args.variants.split(",")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    built = _build(names, str(build.build_dir() / "tiled_variants"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = _weights(gen)
    rows = []
    for name, (_, ptxas) in built.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    for rnd in range(ROUNDS):
        for name, (fn, _) in built.items():
            if fn is None:
                continue
            row = {"variant": name, "round": rnd}
            for m in (512, 256):
                res = _time_layer(fn, gen, cases, m,
                                  check=VARIANTS[name][1] and rnd == 0)
                row.update({f"M{m}_{key}": v for key, v in res.items()})
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "ptxas": {n: p for n, (_, p) in built.items()},
                   "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
