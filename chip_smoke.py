#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does,
   and records its clocks, power draw and temperature (sampled again
   after each kernel timing).
2. build   -- builds the six kernels and the two rank projections from
   ``src/repro_torch/csrc`` (four libraries, one ``nvcc`` each, in
   parallel): five dequant-matmul kernels and flash attention.
3. kernels -- holds each kernel against its plain PyTorch version on the
   card in bf16 at the main-path shapes of llama7b-proxy int4 g32 (M = 4
   for the GEMV kernels, M = 512 for the tiled ones; the slot GEMV with
   ids [1, 2, 0, 3] over a 5-row adapter bank), the tiled ``qmatmul`` also
   at M = 256 (the continuous path's ragged step: 4 slots x 64-token
   chunks) and the tiled ``qalora_matmul`` there too, the rank projection
   (``qalora_rank_proj``, the first launch of kernels 3 and 4) on its own
   at M = 512, 256 and 4, and kernel 5's slot projection
   (``qalora_slot_rank_proj``) at M = 4 (and 1 and 8), plus a sweep of
   bits {2, 3, 4, 8} (the slot GEMV also at M = 1 and 8), a sweep of the
   GEMV's M, the slot GEMV with every id 0 against ``qmatvec`` bit for
   bit, and an edge sweep of the two tiled kernels (M around their tiles,
   N not 16-aligned, every group size ``block_k`` takes, both scale
   dtypes).  The tiled rows record the kernel's design: tile, stages,
   shared memory, and registers and spills from the ptxas report.  Times
   kernel, plain version and the PyTorch library calls on the
   pre-dequantised weight (``library_ms``) with CUDA events, rotating over
   enough weight copies to keep the 50 MB L2 cold; the GEMV kernels, the
   projections and their library calls, which take a few microseconds of
   device time a call, by replaying CUDA graphs of those calls (the GEMV
   rows keep their eager times beside them); at M = 256 also the ragged
   step's whole multi-tenant linear (tiled kernel plus plain bank delta)
   and the bank delta alone.
4. flash   -- kernel 6, ``repro_torch.kernels.ops.flash_mha``, causal, in
   bf16 at the attention shapes of llama7b-proxy (B 4, S 2048, 32 heads,
   d 128) and gemma3-1b (B 4, S 4096, 4 heads, d 256, its one KV head
   repeated to 4; local layers with window 512, global ones without),
   launch counts read around those three calls, and the design each call
   reports it launched (the wgmma design must have run every row); each
   held row by row (every query row within 2**-6 of its own largest
   output) against the plain version on the card and against
   ``scaled_dot_product_attention``, the llama row also against the port
   model's ``flash_attention``; kernel, plain version and
   ``scaled_dot_product_attention`` timed with CUDA events on two input
   copies (L2 cold), SDPA once as called and once forced to each of its
   backends, the fastest by name being ``library_ms``; the ptxas
   registers and spills of the wgmma design (no spills allowed); then a
   sweep at small shapes
   against the plain version: bf16 and f32, every head dim, causal or
   not, window 0 or 16, Sq != Sk both ways, ragged lengths, and rows that
   see no key.  No served path calls it, as in the JAX package.
5. small   -- a reduced model on the card (kernels) against the same
   weights on the CPU (plain versions).
6. serve   -- ``repro_torch.launch.serve`` on the full llama7b-proxy
   (32 layers, d 4096, d_ff 11008, vocab 32000, int4 g32 r64, bf16):
   4 requests x 128 prompt + 32 generated tokens, decoded by replaying
   the captured decode step (one capture, its budget), then the merge
   check; the kernels of that path must have launched on that run,
   kernel 2 once per linear of each of the 31 decode steps and of the
   merge check's merged decode step (the counts of a replay are added by
   the graph cache), kernel 3 once per linear of the merge check's
   unmerged prefill (224), kernel 4 once per linear of its unmerged
   decode step (224), and the rank projection with each of them (448;
   kernel 4's C entry launches its projection itself and reports each of
   its two launches, which the wrapper counts).  One replay of the
   captured step under ``torch.profiler`` must show, kernel by kernel,
   the launches the graph cache adds a replay.  Then the same prompts
   through a generator that replays the step and one that runs it op by
   op (``--loop``), each captured or warmed by a first pass and then run
   in turns: greedy tokens identical to the main run's on both, and
   their decode ms a token.
7. adapters -- ``repro_torch.launch.serve --engine continuous`` on the full
   llama7b-proxy with three demo tenants and the null adapter over one
   INT4 base: 8 requests x 128 prompt + 32 generated tokens on 4 slots,
   prefill chunks of 64, decode bursts of 8.  The slot GEMV and its slot
   projection (counted from what kernel 5's C entry reports it launched)
   must each launch 224 times per decode model step and the
   tiled kernel 224 times per ragged step; each tenant's slot-routed
   logits (the null adapter's too) must match its merged tree, and be nearer it than the next tenant's
   merged tree, both with every row bound to one tenant and in one batch
   whose rows cycle the tenants and the null adapter.  The greedy tokens
   each tenant gives on the same prompts are recorded.  The ragged step
   and the bursts replay captured graphs: at most one capture of the
   ragged step and one per burst length (budgets 1 and 4, declared to a
   ``CompileGuard``); one replay of each graph under ``torch.profiler``
   must show the launches the graph cache adds.  Then the same requests
   through an engine that replays its steps and one that runs them op by
   op (``eager=True``), each captured or warmed by a first pass and then
   run in turns: streams identical to the main run's, and their ms a
   decode model step and a ragged step.
8. train_small -- one QA-LoRA train step (``repro_torch.launch.steps``)
   of llama7b-proxy at full width and 2 layers, bf16, remat on, on a
   batch of 2 x 128 tokens from the port's stream: on the card through
   kernel 3 and its projection (twice per linear: once more when remat
   recomputes the block), against the same step on the CPU through the
   plain versions on the same weights upcast to f32; the loss and each
   adapter gradient within limits set from the H100's readings, the f32
   updates of A and B and the updated B within bounds argued from bf16's
   8-bit significand; and, as the loss limit's measure, how far the card's
   loss moves with every B zeroed (the adapter term dropped).
9. train    -- ``repro_torch.launch.train``'s own ``setup`` and ``run`` on
   the full llama7b-proxy (int4 g32 r64, bf16, remat): 4 steps of 16 x 256
   tokens of alpaca, lr 2e-4, max grad norm 0.3, a checkpoint every 2 steps
   under ``build/`` (removed at the end); the codes, scales and zeros bit
   for bit unchanged, B nonzero after step 1, kernel 3 and its projection
   2 x 224 times a step and no other kernel; the merged result against the
   trained adapter model (``serve.merge_check``, kernels 1-4); then steps
   3-4 again from the step-2 checkpoint, with the same losses and adapters
   bit for bit.  Step wall ms, tokens/s, peak memory, and kernel 3's and
   the plain backward's shares of a step; kernel 3 and its projection
   held against their plain versions at the step's M = 4096 on one
   layer's 7 linears.
10. baselines -- the paper's contrast at full llama7b-proxy size, on a
   float stand-in base drawn from seed 0 (bf16), with calibration
   activations of 2048 rows a D_in (lognormal per-feature scales) and one
   f64 GPTQ Hessian per D_in built on the card: ``convert_tree`` with a
   GPTQ closure over all 224 linears into int4 g32 r64 ``qalora`` (wall
   time); GPTQ's output MSE at or below RTN's on each of layer 0's 7
   linears; GPTQ on the card against the CPU on ``W[:, :256]`` of layer
   0's wq (at least 99.99 % identical codes, none more than one level
   apart); that model's adapters nudged, merged and served statically (4 x
   (128 + 32), the decode step replayed) with the merge check, counted
   launches of kernels 1-4 and 3a against one replay under
   ``torch.profiler``, kernels 1 and 2 held against their plain versions
   on its merged layer-0 linears.  Then the base converted to ``qlora``
   (NF4 wall), 2 steps of 4 x 256 through ``launch/train.py``'s
   ``setup(params=)`` / ``run`` (no port kernel), merged to the float
   '4+16' model and post-training quantized to ``intq`` int4 g32 by RTN
   and by the GPTQ closure; the GPTQ PTQ model served through kernels 1
   and 2; each PTQ model's max|logit gap| / max|logit| against the 4+16
   model beside the QA-LoRA merge's (the paper's contrast: it must be
   larger).  Then ``launch/serve.py --policy "*=int4,lm_head=int4"
   --verify``: 225 linears a step, the head (K = 4096, N = 32000)
   through kernel 4 unmerged and kernel 2 merged (a prefill's logits are
   its last token's, so the head sees M = 4 rows there too), launch counts
   exact and against the profiler, the decode step's replay time, and the
   four kernels held and timed at the head's shape (kernels 3 and 1 at
   M = 512: what a head over many rows, as training's xent, reaches).  Last, one lora and one
   qlora train step of 2-layer llama7b-proxy on the card against the CPU
   (as phase 8).
11. the ``kernels`` summary, and the final ``{"ok": true, ...}`` line.

Any failed phase exits non-zero before the final line.  Without a card,
or without the repository's ``src`` beside this file, it exits non-zero
and prints no result.  Writes everything also to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import dataclasses
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
# the slot GEMV: a 5-row bank (row 0 the null adapter) and one id per row
SLOT_BANK_ROWS = 5
SLOT_IDS = {1: [1], 4: [1, 2, 0, 3], 8: [1, 2, 0, 3, 4, 1, 0, 2]}
SLOT_SWEEP_M = (1, 8)
# the GEMV at M = 1, 4, 8 on one shape: a time that grows with M points at
# the multiply-adds, a flat one at the bytes in flight
GEMV_M_SWEEP = ((1, 8), (4096, 11008))
# the continuous path's ragged step (phase adapters): 4 slots x 64-token
# chunks reach the tiled kernel at M = 256, one adapter id per slot, and
# the plain bank delta is added to its output
RAGGED_SLOTS, RAGGED_CHUNK = 4, 64
RAGGED_M = RAGGED_SLOTS * RAGGED_CHUNK
RAGGED_SLOT_IDS = (1, 2, 3, 0)
GEMV_MAX_M = 8  # repro_torch.kernels.qmatvec.GEMV_MAX_M
L2_BYTES = 50e6
# the tiled kernels' edges: M around their row tiles, N of 96, 100 (not
# 16-aligned) and 200, every group size block_k takes with K = 2 *
# block_k(g) + g (a last K step of one group); bits and the scale dtype
# cycle over the cases
EDGE_M = (9, 65, 127, 129, 257)
EDGE_N = (96, 100, 200)
EDGE_G = (16, 24, 32, 64, 128)
EDGE_RANK = 16
# the first launch of kernels 3 and 4: t = bf16(pool_g(x) @ A), one per
# linear
PROJ = ("qalora_rank_proj", "src/repro_torch/csrc/rank_proj.cuh",
        "src/repro/kernels/qalora_fused.py:62")
# kernel 5's first launch: t[i] = bf16(pool_g(x[i]) @ A[ids[i]])
SLOT_PROJ = ("qalora_slot_rank_proj", "src/repro_torch/csrc/rank_proj.cuh",
             "src/repro/kernels/qmatvec.py:212")

KERNELS = {
    # name: (what it adds to the base product, M, source, Pallas function
    # replaced)
    "qmatmul": ("base", TILED_M, "src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:76"),
    "qmatvec": ("base", GEMV_M, "src/repro_torch/csrc/qmatvec.cu",
                "src/repro/kernels/qmatvec.py:68"),
    "qalora_matmul": ("adapter", TILED_M,
                      "src/repro_torch/csrc/qalora_fused.cu",
                      "src/repro/kernels/qalora_fused.py:62"),
    "qalora_matvec": ("adapter", GEMV_M, "src/repro_torch/csrc/qmatvec.cu",
                      "src/repro/kernels/qmatvec.py:133"),
    "qalora_slot_matvec": ("slot", GEMV_M, "src/repro_torch/csrc/qmatvec.cu",
                           "src/repro/kernels/qmatvec.py:212"),
}
# kernel 6 at the attention shapes of the two configs, bf16, causal:
# (row, B, S, heads, KV heads, head dim, window)
FLASH_ROWS = (("llama7b-proxy", 4, 2048, 32, 32, 128, 0),
              ("gemma3-1b local", 4, 4096, 4, 1, 256, 512),
              ("gemma3-1b global", 4, 4096, 4, 1, 256, 0))
FLASH_SOURCE = "src/repro_torch/csrc/flash.cu"
FLASH_REPLACES = "src/repro/kernels/flash.py:73"
FLASH_DIMS = (16, 32, 64, 128, 256)
# the sweep's (Sq, Sk, causal, window), at every head dim and both dtypes:
# Sq != Sk both ways, ragged lengths, rows that see no key ((64, 16, False,
# 8) and, causal, (96, 40, True, 16))
FLASH_SWEEP = [(128, 128, c, w) for c in (True, False) for w in (0, 16)] + [
    (64, 128, False, 0), (128, 64, True, 0), (64, 16, False, 8),
    (100, 100, True, 16), (72, 40, False, 0), (96, 40, True, 16)]
# bf16, per query row: max|y - ref| over the row within 2**-6 of that row's
# own max|ref| (a wrong key tile in a deep row, whose outputs average
# thousands of keys and are far below the tensor's max, shows here; one
# bf16 step of disagreement is half the bound)
FLASH_BF16_ROW_TOL = 2.0 ** -6
# the port model's attention against the kernel (llama row): the bf16 bound
# of tests/test_flash_kernel.py (the model keeps p in f32), and the row-wise
# bound above
FLASH_MODEL_TOL = 5e-2
# f32 sweep: the bound of tests/test_flash_kernel.py
FLASH_F32_TOL = 2e-4
# the design bf16 at d 128 and 256 must launch (flash_mha_cuda.last_design)
FLASH_DESIGN = "wgmma_tma"
# PyTorch's SDPA backends, each forced in turn (torch.nn.attention)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")

# the kernels each served path must launch
STATIC_PATH = ("qmatmul", "qmatvec", "qalora_matmul", "qalora_matvec",
               "qalora_rank_proj")
ADAPTER_PATH = ("qmatmul", "qalora_slot_matvec", "qalora_slot_rank_proj")
LAYER_LINEARS = sum(c for _, _, c in SHAPES)  # 7 quantized linears a layer

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
    """Builds every library afresh in its own directory, so the build time
    and the ptxas report are this run's."""
    import shutil
    from repro_torch.kernels import build
    bdir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(bdir, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = bdir
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
          "per_source_seconds": per_source, "sources": list(build.SOURCES),
          "design": {n: _design(n) for n in ("qmatmul", "qalora_matmul")}})


# each kernel's entry in the ptxas report (a fragment of its mangled name,
# bits 4 and bf16 scales: the served instantiation)
PTXAS_ENTRY = {
    "qmatmul": ("qmatmul", "tiled_kernelILi4E13__nv_bfloat16Lb0E"),
    "qalora_matmul": ("qalora_fused", "tiled_kernelILi4E13__nv_bfloat16Lb1E"),
    "qalora_rank_proj": ("qalora_fused", "rank_proj_kernelILi4ELb0E"),
    "qmatvec": ("qmatvec", "gemv_kernelILi4E13__nv_bfloat16Li0E"),
    "qalora_matvec": ("qmatvec", "gemv_kernelILi4E13__nv_bfloat16Li1E"),
    "qalora_slot_matvec": ("qmatvec", "gemv_kernelILi4E13__nv_bfloat16Li2E"),
    "qalora_rank_proj_gemv": ("qmatvec", "rank_proj_kernelILi1ELb0E"),
    "qalora_slot_rank_proj": ("qmatvec", "rank_proj_kernelILi1ELb1E"),
}


def _ptxas(name):
    """Registers and spills of one kernel from its library's ptxas report
    (bits 4, bf16 scales)."""
    from repro_torch.kernels import build
    lib, entry = PTXAS_ENTRY[name]
    return build.ptxas_report(build.BUILD_LOG.get(lib, ""), entry)


def _design(name):
    """The tiled kernel's tile, threads, stages and dynamic shared memory
    at the served operands (int4, g = 32: K step 64; bf16 scales; r = RANK
    for kernel 3), with its ptxas numbers."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.qmatmul import block_k
    out = (ctypes.c_int * 5)()
    rank = RANK if name == "qalora_matmul" else 0
    build.library("qmatmul").tiled_design(block_k(GROUP), GROUP, rank, BITS,
                                          0, out)
    return {"tile": f"{out[0]}x{out[1]}", "threads": out[2],
            "stages": out[3], "bk": block_k(GROUP), "smem_bytes": out[4],
            "ptxas": _ptxas(name)}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _bound(m, k, n, bits, n_adapters=0, adapter_rows=None, scale_bytes=2,
           ab_bytes=2, x_bytes=2):
    """Least time for the work: bytes (each input read once, the output
    written once) over the memory rate, or operations over the bf16 peak.
    ``n_adapters`` distinct adapters' A and B are read (the slot GEMV: the
    distinct non-null ids of this run's data, plus its m int32 ids), and
    ``adapter_rows`` rows of x (default all m) go through an adapter."""
    from repro_torch.core.quant import codes_per_byte
    groups = k // GROUP
    nbytes = (k // codes_per_byte(bits)) * n + 2 * groups * n * scale_bytes \
        + m * k * x_bytes + m * n * x_bytes
    flops = 2 * m * k * n
    if n_adapters:
        rows = m if adapter_rows is None else adapter_rows
        nbytes += n_adapters * (groups * RANK + RANK * n) * ab_bytes
        if adapter_rows is not None:
            nbytes += 4 * m
        flops += 2 * rows * (groups * RANK + RANK * n)
    return _bound_of(nbytes, flops)


def _bound_of(nbytes, flops):
    """The larger of bytes over the memory rate and operations over the
    bf16 peak, and which of the two it is."""
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


def _time_graph_ms(torch, fn, arg_sets, iters):
    """Device time of one call, for calls shorter than the host's cost of
    issuing them: ``iters`` calls rotating through ``arg_sets`` are
    captured in one CUDA graph, and one replay is timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case(torch, gen, m, k, n, bits, kind):
    """Inputs for one kernel call: the quantized weight, then what the
    kernel adds (adapter A and B, or the slot GEMV's banks and ids), all
    bf16 but the ids."""
    from repro_torch.core import quant
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quant.quantize(w, bits, GROUP, scale_dtype=torch.bfloat16)
    del w
    if kind == "base":
        return qt, ()
    rows = (SLOT_BANK_ROWS,) if kind == "slot" else ()
    a = (torch.randn(rows + (k // GROUP, RANK), generator=gen, device="cuda")
         / math.sqrt(k // GROUP) + 0.01).to(torch.bfloat16)
    b = (torch.randn(rows + (RANK, n), generator=gen, device="cuda") * 0.01
         + 0.01).to(torch.bfloat16)
    if kind == "adapter":
        return qt, (a, b)
    a[0] = 0  # the null adapter
    b[0] = 0
    ids = torch.tensor(SLOT_IDS[m], dtype=torch.int32, device="cuda")
    return qt, (a, b, ids)


def _calls(name):
    from repro_torch import kernels
    from repro_torch.kernels import qalora_fused, qmatmul, qmatvec
    plain = {"qmatmul": qmatmul.qmatmul_plain, "qmatvec": qmatvec.qmatvec_plain,
             "qalora_matmul": qalora_fused.qalora_matmul_plain,
             "qalora_matvec": qmatvec.qalora_matvec_plain,
             "qalora_slot_matvec": qmatvec.qalora_slot_matvec_plain}[name]
    return kernels.KERNELS[name], plain


def _library_fn(torch, kind, x):
    """One PyTorch call for the same function, where there is one: cuBLAS
    on the pre-dequantised weight (the adapter folded into it for kernels 3
    and 4).  No single call gathers an adapter per row, so for the slot
    GEMV it is cuBLAS for the base plus ``torch.bmm`` / ``torch.baddbmm``
    on A and B rows gathered beforehand."""
    if kind != "slot":
        return lambda w: x @ w
    m, k = x.shape

    def slot(w, a_sel, b_sel):
        pooled = x.reshape(m, 1, k // GROUP, GROUP).sum(-1)
        return torch.baddbmm((x @ w)[:, None], torch.bmm(pooled, a_sel),
                             b_sel, alpha=S)[:, 0]
    return slot


def _library_args(torch, kind, q, extra):
    from repro_torch.core.qalora import QALoRAParams
    from repro_torch.core.schemes import LinearParams, QuantPolicy, dense_view
    mode = "qalora" if kind == "adapter" else "intq"
    pol = QuantPolicy(mode=mode, bits=q.bits, group_size=GROUP, rank=RANK,
                      s=S)
    data = {"q": q, "ad": QALoRAParams(*extra)} if kind == "adapter" \
        else {"q": q}
    w = dense_view(LinearParams(data, pol.mode, pol), torch.bfloat16)
    if kind != "slot":
        return (w,)
    a, b, ids = extra
    rows = ids.to(torch.int64)
    return (w, a[rows].contiguous(), b[rows].contiguous())


def _check_one(torch, name, m, k, n, bits, gen, timing):
    """Kernel vs plain on one shape; optional timings.  Tolerance: both
    round w to bf16 at the same point and multiply exactly in f32, so
    they differ only in f32 summation order (and, with an adapter, where a
    pooled sum rounds to bf16): each bf16 output may land on a
    neighbouring value, two bf16 steps of the largest output at most,
    2**-6 * max|y|.  The slot GEMV with every id 0 must give qmatvec's
    output bit for bit (same base loop and split, adapter skipped)."""
    kind = KERNELS[name][0]
    kern, plain = _calls(name)
    qt, extra = _case(torch, gen, m, k, n, bits, kind)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)

    def args_of(q, ex):
        return (x, q.qweight, q.scale, q.zero) + ex
    kw = dict(bits=bits, group_size=GROUP)
    if kind != "base":
        kw["s"] = S
    y = kern(*args_of(qt, extra), **kw)
    ref = plain(*args_of(qt, extra), **kw)
    torch.cuda.synchronize()
    yf, rf = y.float(), ref.float()
    err = (yf - rf).abs().max().item()
    tol = 2.0 ** -6 * rf.abs().max().item()
    row = {"kernel": name, "M": m, "K": k, "N": n, "bits": bits,
           "max_abs_err": err, "tol": tol,
           "finite": bool(torch.isfinite(yf).all())}
    ok = row["finite"] and err <= tol
    if kind == "slot":
        ids = SLOT_IDS[m]
        row["ids"] = ids
        row.update(_bound(m, k, n, bits, n_adapters=len(set(ids) - {0}),
                          adapter_rows=sum(i != 0 for i in ids)))
        from repro_torch.kernels.qmatvec import qmatvec_cuda
        zeros = torch.zeros_like(extra[2])
        y0 = kern(*args_of(qt, extra[:2] + (zeros,)), **kw)
        base = qmatvec_cuda(x, qt.qweight, qt.scale, qt.zero, **{
            k_: v for k_, v in kw.items() if k_ != "s"})
        row["null_ids_bit_identical"] = bool(torch.equal(y0, base))
        ok = ok and row["null_ids_bit_identical"]
    else:
        row.update(_bound(m, k, n, bits, n_adapters=int(kind == "adapter")))
    if timing:
        per_copy = qt.qweight.numel() + 4 * qt.scale.numel()
        copies = [(qt, extra)] + [
            _case(torch, gen, m, k, n, bits, kind)
            for _ in range(max(1, math.ceil(2.5 * L2_BYTES / per_copy)) - 1)]
        calls = [args_of(q, ex) for q, ex in copies]
        lib = [_library_args(torch, kind, q, ex) for q, ex in
               copies[:max(2, math.ceil(2.5 * L2_BYTES / (2 * k * n)))]]
        while len(lib) < 2:
            lib.append(tuple(t.clone() for t in lib[0]))
        lib_fn = _library_fn(torch, kind, x)
        row["kernel_ms"] = _time_ms(torch, lambda *t: kern(*t, **kw), calls,
                                    50)
        row["library_ms"] = _time_ms(torch, lib_fn, lib, 50)
        if m <= GEMV_MAX_M:
            # a GEMV call takes a few microseconds of device time, less than
            # the host's cost of issuing it: kernel and library are timed
            # by CUDA-graph replay, the eager times kept beside them
            row["kernel_eager_ms"] = row["kernel_ms"]
            row["library_eager_ms"] = row["library_ms"]
            row["kernel_ms"] = _time_graph_ms(
                torch, lambda *t: kern(*t, **kw), calls, 50)
            row["library_ms"] = _time_graph_ms(torch, lib_fn, lib, 50)
            row["timing"] = "CUDA-graph replay (eager beside it)"
        row["clocks"] = _smi(CLOCKS)
        row["plain_ms"] = _time_ms(
            torch, lambda *t: plain(*t, **kw), calls, 5)
        del copies, lib, calls
    row["ok"] = ok
    emit({"phase": "kernel_row", **row})
    if not ok:
        raise AssertionError(f"{name} M={m} K={k} N={n} bits={bits}: "
                             f"max_abs_err {err} > tol {tol}, or the null "
                             f"ids were not bit-identical to qmatvec")
    return row


def _time_ragged_linear(torch, gen, k, n):
    """The ragged step's whole multi-tenant linear at M = ``RAGGED_M``
    (the tiled kernel plus the plain bank delta, ``ops._slot_matmul_tiled``)
    and the bank delta alone, on one shape: the tiled kernel's own time
    at that M is the ``qmatmul`` row beside it."""
    from repro_torch.core.qalora import bank_adapter_delta
    from repro_torch.kernels import ops
    ids = torch.tensor(RAGGED_SLOT_IDS, dtype=torch.int32, device="cuda") \
        .repeat_interleave(RAGGED_CHUNK)
    x = torch.randn((RAGGED_M, k), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    qt, (a, b, _) = _case(torch, gen, GEMV_M, k, n, BITS, "slot")
    per_copy = qt.qweight.numel() + 4 * qt.scale.numel() + 2 * b.numel()
    copies = [(qt, a, b)] + [
        (q,) + ex[:2] for q, ex in (
            _case(torch, gen, GEMV_M, k, n, BITS, "slot") for _ in range(
                max(1, math.ceil(2.5 * L2_BYTES / per_copy)) - 1))]
    row = {"path": "ragged step", "M": RAGGED_M, "K": k, "N": n,
           "ids": list(RAGGED_SLOT_IDS), "rows_per_id": RAGGED_CHUNK,
           "bank_rows": SLOT_BANK_ROWS}
    row["slot_tiled_ms"] = _time_ms(
        torch, lambda q, a_, b_: ops._slot_matmul_tiled(
            x, q.qweight, q.scale, q.zero, a_, b_, ids, s=S, bits=BITS,
            group_size=GROUP), copies, 20)
    row["bank_delta_ms"] = _time_ms(
        torch, lambda q, a_, b_: bank_adapter_delta(x, a_, b_, ids, S, GROUP),
        copies, 20)
    emit({"phase": "ragged_linear_row", **row})
    del copies
    return row


def _check_proj(torch, m, k, gen, slot=False, gemv=False):
    """The rank projection alone, t = bf16(pool_g(x) @ A) [m, RANK]: kernel
    3's first launch, or with ``gemv`` kernel 4's (its one-row-a-block
    form, through its C entry, since the served path launches it from
    kernel 4's), or with ``slot`` kernel 5's, row i
    from bank row ids[i] of a SLOT_BANK_ROWS-row bank (ids SLOT_IDS[m]);
    against its plain version (two bf16 steps of max|t|: a pooled sum in
    another order may round to a neighbouring bf16 value).  Kernel and
    library are timed from CUDA graphs (a few microseconds a call: eager
    calls measure the host's launch rate) over copies of x and A that keep
    the L2 cold; the library is one cuBLAS product of x with A repeated
    over each group's rows (``torch.bmm`` on the rows' A, gathered
    beforehand, for the slot variant): the same function, rounded once."""
    from repro_torch.kernels import build
    from repro_torch.kernels.qalora_fused import (qalora_rank_proj_cuda,
                                                  qalora_rank_proj_plain)
    from repro_torch.kernels.qmatvec import (qalora_slot_rank_proj_cuda,
                                             qalora_slot_rank_proj_plain)
    groups = k // GROUP
    rows = (SLOT_BANK_ROWS,) if slot else ()
    ids = torch.tensor(SLOT_IDS[m], dtype=torch.int32, device="cuda") \
        if slot else None

    def inputs():
        x = torch.randn((m, k), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        a = (torch.randn(rows + (groups, RANK), generator=gen, device="cuda")
             / math.sqrt(groups) + 0.01).to(torch.bfloat16)
        if slot:
            a[0] = 0  # the null adapter
        return x, a
    if slot:
        kern = lambda x_, a_: qalora_slot_rank_proj_cuda(  # noqa: E731
            x_, a_, ids, group_size=GROUP)
        plain = lambda x_, a_: qalora_slot_rank_proj_plain(  # noqa: E731
            x_, a_, ids, group_size=GROUP)
        n_ad = len(set(SLOT_IDS[m]) - {0})
        bound = _bound_of(2 * (m * k + n_ad * groups * RANK + m * RANK) + 4 * m,
                          m * k + 2 * sum(i != 0 for i in SLOT_IDS[m])
                          * groups * RANK)
    else:
        if gemv:
            lib = build.library("qmatvec")

            def kern(x_, a_):
                t_ = torch.empty((m, RANK), dtype=torch.bfloat16,
                                 device="cuda")
                build.check(lib.qalora_gemv_rank_proj_bf16(
                    x_.data_ptr(), a_.data_ptr(), t_.data_ptr(), m, k, GROUP,
                    RANK, build.current_stream()),
                    "qalora_gemv_rank_proj_bf16")
                return t_
        else:
            kern = lambda x_, a_: qalora_rank_proj_cuda(  # noqa: E731
                x_, a_, group_size=GROUP)
        plain = lambda x_, a_: qalora_rank_proj_plain(  # noqa: E731
            x_, a_, group_size=GROUP)
        bound = _bound_of(2 * (m * k + groups * RANK + m * RANK),
                          m * k + 2 * m * groups * RANK)
    per_copy = 2 * m * k + 2 * math.prod(rows) * groups * RANK
    n_copies = min(2000, max(2, math.ceil(2.5 * L2_BYTES / per_copy)))
    copies = [inputs() for _ in range(n_copies)]
    x, a = copies[0]
    t = kern(x, a)
    ref = plain(x, a)
    torch.cuda.synchronize()
    err = (t.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -6 * ref.float().abs().max().item()
    name = SLOT_PROJ[0] if slot else PROJ[0]
    row = {"kernel": name, "M": m, "K": k, "rank": RANK,
           "max_abs_err": err, "tol": tol,
           "finite": bool(torch.isfinite(t.float()).all()), **bound}
    if slot:
        row["ids"] = SLOT_IDS[m]
        row["null_rows_zero"] = bool((t[ids == 0] == 0).all())
    iters = max(50, n_copies)
    row["kernel_ms"] = _time_graph_ms(torch, kern, copies, iters)
    row["plain_ms"] = _time_ms(torch, plain, copies, 5)

    def lib_args(x_, a_):
        if not slot:
            return x_, a_.repeat_interleave(GROUP, 0)
        return (x_[:, None, :],
                a_[ids.to(torch.int64)].repeat_interleave(GROUP, 1))
    lib_bytes = 2 * k * RANK * (m if slot else 1)
    lib = [lib_args(*c) for c in copies[:max(2, min(n_copies, math.ceil(
        2.5 * L2_BYTES / lib_bytes)))]]
    lib_fn = torch.bmm if slot else (lambda x_, ar: x_ @ ar)
    row["library_ms"] = _time_graph_ms(torch, lib_fn, lib,
                                       max(50, len(lib)))
    del copies, lib
    row["ok"] = row["finite"] and err <= tol and row.get("null_rows_zero",
                                                         True)
    emit({"phase": "kernel_row", **row})
    if not row["ok"]:
        raise AssertionError(f"{name} M={m} K={k}: max_abs_err {err} > "
                             f"tol {tol}, or a null row was not zero")
    return row


def _edge_sweep(torch, gen):
    """The two tiled kernels against their plain versions at their edges
    (EDGE_M x EDGE_N x EDGE_G, bits and scale dtype cycling), each within
    2**-6 * max|plain|.  Returns the number of kernel calls checked."""
    from repro_torch.core import quant
    from repro_torch.kernels.qmatmul import block_k
    calls, worst, bad = 0, 0.0, []
    cases = [(g, m, n) for g in EDGE_G for m in EDGE_M for n in EDGE_N]
    for i, (g, m, n) in enumerate(cases):
        bits = (2, 3, 4, 8)[i % 4]
        sd = (torch.bfloat16, torch.float32)[(i // 4) % 2]
        k = 2 * block_k(g) + g
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        qt = quant.quantize(w, bits, g, scale_dtype=sd)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        a = (torch.randn((k // g, EDGE_RANK), generator=gen, device="cuda")
             / math.sqrt(k // g) + 0.01).to(torch.bfloat16)
        b = (torch.randn((EDGE_RANK, n), generator=gen, device="cuda") * 0.05
             + 0.01).to(torch.bfloat16)
        for name in ("qmatmul", "qalora_matmul"):
            kern, plain = _calls(name)
            args = (x, qt.qweight, qt.scale, qt.zero)
            kw = dict(bits=bits, group_size=g)
            if name == "qalora_matmul":
                args += (a, b)
                kw["s"] = S
            y, ref = kern(*args, **kw).float(), plain(*args, **kw).float()
            ratio = (y - ref).abs().max().item() / (
                2.0 ** -6 * ref.abs().max().item())
            calls += 1
            worst = max(worst, ratio)
            if not (bool(torch.isfinite(y).all()) and ratio <= 1):
                bad.append({"kernel": name, "M": m, "N": n, "K": k, "g": g,
                            "bits": bits, "scale": str(sd), "ratio": ratio})
    out = {"phase": "edge_sweep", "calls": calls, "M": EDGE_M, "N": EDGE_N,
           "g": EDGE_G, "rank": EDGE_RANK,
           "worst_err_over_tol": worst, "failures": bad[:10], "ok": not bad}
    emit(out)
    if bad:
        raise AssertionError(f"edge sweep: {len(bad)} failures, {bad[:3]}")
    return calls


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (_, m, _, _) in KERNELS.items():
        rows[name] = [_check_one(torch, name, m, k, n, BITS, gen, timing=True)
                      for k, n, _ in SHAPES]
    rows[PROJ[0]] = [_check_proj(torch, TILED_M, k, gen) for k, _, _ in SHAPES]
    # the projections the GEMV kernels launch: kernel 4's, and kernel 5's
    # slot projection
    gemv_proj = [_check_proj(torch, GEMV_M, k, gen, gemv=True)
                 for k, _, _ in SHAPES]
    rows[SLOT_PROJ[0]] = [_check_proj(torch, GEMV_M, k, gen, slot=True)
                          for k, _, _ in SHAPES]
    sweep_proj = [_check_proj(torch, m, SWEEP_SHAPE[0], gen, slot=True)
                  for m in SLOT_SWEEP_M]
    # the tiled kernels (and kernel 3's projection) at the continuous path's
    # ragged-step M, and that step's whole multi-tenant linear
    ragged = [_check_one(torch, "qmatmul", RAGGED_M, k, n, BITS, gen,
                         timing=True) for k, n, _ in SHAPES]
    for row, (k, n, _) in zip(ragged, SHAPES):
        row.update(_time_ragged_linear(torch, gen, k, n))
    ragged_adapter = [_check_one(torch, "qalora_matmul", RAGGED_M, k, n, BITS,
                                 gen, timing=True) for k, n, _ in SHAPES]
    ragged_proj = [_check_proj(torch, RAGGED_M, k, gen) for k, _, _ in SHAPES]
    edge_calls = _edge_sweep(torch, gen)
    sweep = [_check_one(torch, name, KERNELS[name][1], *SWEEP_SHAPE, bits, gen,
                        timing=False)
             for bits in (2, 3, 4, 8) for name in KERNELS]
    sweep += [_check_one(torch, "qalora_slot_matvec", m, *SWEEP_SHAPE, bits,
                         gen, timing=False)
              for bits in (2, 3, 4, 8) for m in SLOT_SWEEP_M]
    ms, (k, n) = GEMV_M_SWEEP
    sweep += [_check_one(torch, "qmatvec", m, k, n, BITS, gen, timing=True)
              for m in ms]
    emit({"phase": "kernels_checked", "rows": sum(map(len, rows.values()))
          + len(ragged) + len(ragged_adapter) + len(ragged_proj) + len(sweep)
          + len(gemv_proj) + len(sweep_proj),
          "edge_sweep_calls": edge_calls,
          "tolerance": "2**-6 * max|plain| (two bf16 steps)",
          "ragged_step_per_layer_ms": {
              key: _per_layer(ragged, key) for key in
              ("kernel_ms", "bound_ms", "library_ms", "slot_tiled_ms",
               "bank_delta_ms")},
          "ragged_step_qalora_matmul_per_layer_ms": {
              key: _per_layer(ragged_adapter, key) for key in
              ("kernel_ms", "bound_ms", "library_ms")},
          "clocks_after": _smi(CLOCKS)})
    torch.cuda.empty_cache()
    return rows, {"qmatmul": ragged, "qalora_matmul": ragged_adapter,
                  PROJ[0]: ragged_proj, "gemv_proj": gemv_proj}


def _per_layer(rows, key):
    """Sum of one layer's linears: 4 x (4096, 4096) + 2 x (4096, 11008) +
    1 x (11008, 4096)."""
    return sum(r[key] * count for r, (_, _, count) in zip(rows, SHAPES))


# ---------------------------------------------------------------------------
# phase 4: flash attention (kernel 6)
# ---------------------------------------------------------------------------


def _fold(t):
    """[B, S, H, d] -> contiguous [B*H, S, d], as ops.flash_mha folds."""
    b, s_, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s_, d).contiguous()


def _flash_inputs(torch, gen, b, sq, sk, h, kvh, d, dtype):
    """q [B, Sq, H, d], k and v [B, Sk, KvH, d] repeated to H heads on the
    head axis (as ``jnp.repeat(axis=2)`` expands GQA)."""
    def rnd(s_, heads):
        return torch.randn((b, s_, heads, d), generator=gen, device="cuda") \
            .to(dtype)
    q, k, v = rnd(sq, h), rnd(sk, kvh), rnd(sk, kvh)
    if kvh < h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    return q, k, v


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask keeps, per batch-head."""
    import numpy as np
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(sk - 1, i) if causal else np.full_like(i, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_bound(bh, sq, sk, d, causal, window):
    """4 d flops per visible pair (q k^T and p v) over the bf16 peak, or
    q, k, v read once and o written once (bf16) over the memory rate."""
    flops = 4 * d * bh * _visible_pairs(sq, sk, causal, window)
    nbytes = (2 * sq + 2 * sk) * bh * d * 2
    return _bound_of(nbytes, flops)


def _row_ratio(y, ref):
    """Largest max|y - ref| of a query row (the last axis) over
    FLASH_BF16_ROW_TOL times that row's max|ref|: at most 1 passes."""
    yf, rf = y.float(), ref.float()
    return ((yf - rf).abs().amax(-1) / (FLASH_BF16_ROW_TOL
                                        * rf.abs().amax(-1))).max().item()


def _flash_check(torch, y, ref):
    """(max|y - ref|, row ratio or None, ok): bf16 within the row-wise
    bound (p and o round to bf16 at the same points, p against another
    running max in the kernel's tiles), f32 within rtol = atol =
    FLASH_F32_TOL."""
    yf, rf = y.float(), ref.float()
    diff = (yf - rf).abs()
    ok = bool(torch.isfinite(yf).all())
    ratio = None
    if y.dtype == torch.bfloat16:
        ratio = _row_ratio(y, ref)
        ok = ok and ratio <= 1
    else:
        ok = ok and bool((diff <= FLASH_F32_TOL
                          + FLASH_F32_TOL * rf.abs()).all())
    return diff.max().item(), ratio, ok


def _sdpa_fn(torch, sq, sk, window):
    """One PyTorch call for the same function on [B, H, S, d]: causal, or a
    boolean band for the window (True takes part)."""
    import torch.nn.functional as F
    if not window:
        return lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(sk, device="cuda")[None, :]
    band = (j <= i) & (j > i - window)
    return lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=band)


def _flash_ptxas():
    """{d: registers, stack and spills} of the wgmma design's
    instantiations, from this run's build of flash.cu."""
    import re
    from repro_torch.kernels import build
    from repro_torch.launch import flash_variants
    out = {}
    for entry, rep in flash_variants.flash_ptxas(
            build.BUILD_LOG.get("flash", "")).items():
        m = re.search(r"flash_wgmmaILi(\d+)E", entry)
        if m:
            out[int(m.group(1))] = rep
    return out


def phase_flash(torch):
    """Kernel 6 at full width (the path: counts reset just before the three
    ``ops.flash_mha`` calls and read just after), then its checks, timings
    and the small-shape sweep."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash import flash_mha_cuda, flash_mha_plain
    from repro_torch.launch import flash_variants
    from repro_torch.models.attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [_flash_inputs(torch, gen, b, s_, s_, h, kvh, d, torch.bfloat16)
              for _, b, s_, h, kvh, d, _ in FLASH_ROWS]
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs, designs = [], []
    for (q, k, v), (*_, w) in zip(inputs, FLASH_ROWS):
        outs.append(ops.flash_mha(q, k, v, causal=True, window=w))
        designs.append(flash_mha_cuda.last_design)
    torch.cuda.synchronize()
    counts = kernels.launches()
    rows = []
    for (name, b, s_, h, kvh, d, w), (q, k, v), y, design in zip(
            FLASH_ROWS, inputs, outs, designs):
        folded = [_fold(t) for t in (q, k, v)]
        ref = flash_mha_plain(*folded, causal=True, window=w)
        err, ratio, ok = _flash_check(torch, _fold(y), ref)
        row = {"row": name, "B": b, "S": s_, "H": h, "KvH": kvh, "d": d,
               "window": w, "causal": True, "design": design,
               "max_abs_err": err, "row_err_ratio": ratio, "ok": ok,
               **_flash_bound(b * h, s_, s_, d, True, w)}
        if name == "llama7b-proxy":
            model = flash_attention(q, k, v, causal=True)
            yf, mf = y.float(), model.float()
            excess = ((yf - mf).abs() - FLASH_MODEL_TOL
                      - FLASH_MODEL_TOL * mf.abs()).max().item()
            row["model_max_abs_diff"] = (yf - mf).abs().max().item()
            row["model_within_rtol_atol"] = excess <= 0
            row["model_row_err_ratio"] = _row_ratio(y, model)
            row["ok"] = ok = (ok and excess <= 0
                              and row["model_row_err_ratio"] <= 1)
            del model, yf, mf
        del ref
        copies = [folded, [_fold(t) for t in _flash_inputs(
            torch, gen, b, s_, s_, h, kvh, d, torch.bfloat16)]]
        row["kernel_ms"] = _time_ms(
            torch, lambda *t: flash_mha_cuda(*t, causal=True, window=w),
            copies, 20)
        row["clocks"] = _smi(CLOCKS)
        row["plain_ms"] = _time_ms(
            torch, lambda *t: flash_mha_plain(*t, causal=True, window=w),
            copies, 3)
        lib = [[t.view(b, h, s_, d) for t in c] for c in copies]
        sdpa = _sdpa_fn(torch, s_, s_, w)
        row["library_default_ms"] = _time_ms(torch, sdpa, lib, 20)
        # each SDPA backend forced in turn; the fastest that takes the
        # inputs is the library time
        row["library_backends_ms"] = backends = {}
        for backend in SDPA_BACKENDS:
            forced = flash_variants.sdpa_call(s_, w, backend)
            try:
                forced(*lib[0])
                torch.cuda.synchronize()
            except RuntimeError as e:
                backends[backend] = f"refused: {str(e).splitlines()[0]}"
                continue
            backends[backend] = _time_ms(torch, forced, lib, 20)
        timed = {k_: v_ for k_, v_ in backends.items()
                 if isinstance(v_, float)}
        row["library_backend"] = min(timed, key=timed.get)
        row["library_ms"] = timed[row["library_backend"]]
        lib_y = sdpa(*lib[0])
        row["library_max_abs_diff"] = (
            lib_y.float() - _fold(y).view(b, h, s_, d).float()).abs().max() \
            .item()
        row["library_row_err_ratio"] = _row_ratio(
            lib_y, _fold(y).view(b, h, s_, d))
        row["ok"] = ok = ok and row["library_row_err_ratio"] <= 1
        del copies, lib, lib_y
        emit({"phase": "flash_row", **row})
        rows.append(row)
        if not ok:
            raise AssertionError(f"flash {name}: a check failed: {row}")
    del inputs, outs
    torch.cuda.empty_cache()

    sweep, bad = 0, []
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for d in FLASH_DIMS:
            for sq, sk, causal, w in FLASH_SWEEP:
                q, k, v = _flash_inputs(torch, gen, 1, sq, sk, 2, 2, d, dtype)
                y = ops.flash_mha(q, k, v, causal=causal, window=w)
                ref = flash_mha_plain(_fold(q), _fold(k), _fold(v),
                                      causal=causal, window=w,
                                      block_q=sq, block_k=sk)
                err, ratio, ok = _flash_check(torch, _fold(y), ref)
                sweep += 1
                worst[dtype] = max(worst[dtype], ratio if ratio is not None
                                   else err)
                if not ok:
                    bad.append({"dtype": str(dtype), "d": d, "Sq": sq,
                                "Sk": sk, "causal": causal, "window": w,
                                "max_abs_err": err, "row_err_ratio": ratio})
    ptxas = _flash_ptxas()
    checks = {
        "rows_within_tol": all(r["ok"] for r in rows),
        "sweep_within_tol": not bad,
        "path_launched_flash": counts["flash_mha"] == len(FLASH_ROWS),
        "only_flash_on_path": all(v == 0 for k, v in counts.items()
                                  if k != "flash_mha"),
        "rows_ran_wgmma_design": all(r["design"] == FLASH_DESIGN
                                     for r in rows),
        "wgmma_design_built_without_spills": len(ptxas) == 3 and all(
            r["spill_stores"] == 0 and r["spill_loads"] == 0
            for r in ptxas.values()),
    }
    out = {"phase": "flash", "launches": counts, "sweep_cases": sweep,
           "designs": {r["row"]: r["design"] for r in rows},
           "library_backends": {r["row"]: r["library_backend"]
                                for r in rows},
           "ptxas_wgmma": ptxas,
           "sweep_failures": bad,
           "sweep_bf16_max_row_err_ratio": worst[torch.bfloat16],
           "sweep_f32_max_abs_err": worst[torch.float32],
           "tolerance": "bf16 per query row max|y - ref| <= 2**-6 * "
                        "max_row|ref| (row_err_ratio <= 1), against the "
                        "plain version, the model's attention (llama row) "
                        "and scaled_dot_product_attention; f32 rtol = atol "
                        f"= {FLASH_F32_TOL}; llama row vs model attention "
                        f"also rtol = atol = {FLASH_MODEL_TOL}",
           "checks": checks, "clocks_after": _smi(CLOCKS)}
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"flash checks failed: {checks}, {bad[:5]}")
    return rows, counts["flash_mha"]


# ---------------------------------------------------------------------------
# phase 5: a reduced model on the card against the CPU
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
# phases 6-7: compiled serve steps
# ---------------------------------------------------------------------------

# a port kernel's name as the profiler shows it (demangled or mangled),
# and the launch counter that counts it, by its template argument
_KERNEL_NAMES = (
    (r"gemv_kernel(?:<[^,]*,[^,]*,\s*(?:\(int\))?|ILi\d+E.*?Li)(\d)",
     {"0": "qmatvec", "1": "qalora_matvec", "2": "qalora_slot_matvec"}),
    (r"tiled_kernel(?:<[^,]*,[^,]*,\s*|ILi\d+E.*?Lb)(true|false|0|1)",
     {"false": "qmatmul", "0": "qmatmul", "true": "qalora_matmul",
      "1": "qalora_matmul"}),
    (r"rank_proj_kernel(?:<[^,]*,\s*|ILi\d+ELb)(true|false|0|1)",
     {"false": "qalora_rank_proj", "0": "qalora_rank_proj",
      "true": "qalora_slot_rank_proj", "1": "qalora_slot_rank_proj"}),
)


def _counter_of(kernel: str):
    """The launch counter of a port kernel's name, or None."""
    import re
    for pat, names in _KERNEL_NAMES:
        m = re.search(pat, kernel)
        if m:
            return names[m.group(1)]
    return None


def _replay_profiles(torch, graphs):
    """One replay of every captured graph of the StepGraphs in ``graphs``
    under ``torch.profiler``: the port's kernels it ran, by launch
    counter, beside the launches the graph cache adds a replay.  The
    replays re-run steps whose results are no longer read."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for step in graphs.values():
        for key, g in step.graphs.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                g.replay()
                torch.cuda.synchronize()
            seen, kernels_run = {}, 0
            for evt in prof.key_averages():
                if evt.device_type.name != "CUDA":
                    continue
                kernels_run += evt.count
                name = _counter_of(evt.key)
                if name is not None:
                    seen[name] = seen.get(name, 0) + evt.count
            out[f"{step.name}{list(key[:2])}"] = {
                "launches": dict(g.launches), "profiler": seen,
                "device_kernels": kernels_run,
                "match": seen == dict(g.launches)}
    return out


def _in_turns(run_pass):
    """A first pass of the graphed path and of the eager one (the captures,
    the warm-up), then two rounds with the paths in turns: graphs, eager,
    eager, graphs.  Returns {path: {key: median, "runs": [pass results
    after the first]}}."""
    from statistics import median
    paths = ("graphs", "eager")
    for path in paths:
        run_pass(path)
    runs = {path: [] for path in paths}
    for order in (paths, paths[::-1]):
        for path in order:
            runs[path].append(run_pass(path))
    return {path: {key: median(r[key] for r in rs) for key in rs[0]}
            | {"runs": rs} for path, rs in runs.items()}


# ---------------------------------------------------------------------------
# phase 6: serve the full model
# ---------------------------------------------------------------------------


SERVE_GEN = 32


def _static_walls(torch, want):
    """The static path's steady state: the served model and prompts of
    phase serve through one generator that replays its decode step and
    one that runs it op by op, in turns.  Returns ({path: {decode ms a
    token, prefill ms, runs}}, tokens of every pass equal ``want``)."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.launch import serve
    cfg = C.get("llama7b-proxy")
    lm, _, merged = serve.build_model(cfg, "cuda")
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(4, 128)).astype(np.int32)
    gens = {path: serve.make_graph_generator(
        lm, merged, prompts.shape, SERVE_GEN, 128 + SERVE_GEN,
        device="cuda", eager=path == "eager") for path in ("graphs", "eager")}
    same = []

    def run_pass(path):
        toks, times = gens[path](prompts)
        same.append(bool(np.array_equal(toks, want)))
        return {"decode_ms_per_token": times["decode_s"] * 1e3
                / (SERVE_GEN - 1), "prefill_ms": times["prefill_s"] * 1e3}

    walls = _in_turns(run_pass)
    walls["captures"] = {p: g.graphs._cache_size() for p, g in gens.items()}
    del gens, lm, merged
    _free(torch)
    return walls, all(same)


def phase_serve(torch):
    from repro_torch import kernels
    from repro_torch.launch import serve
    argv = ["--arch", "llama7b-proxy", "--requests", "4", "--prompt-len", "128",
            "--device", "cuda"]
    serve.main(argv + ["--gen-len", "2"])  # warm-up: first-call set-up
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = serve.main(argv + ["--gen-len", str(SERVE_GEN), "--verify"])
    torch.cuda.synchronize()
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    toks = res.pop("tokens")
    graphs = res.pop("graphs")
    replays = _replay_profiles(torch, graphs)
    del graphs
    _free(torch)
    walls, same = _static_walls(torch, toks)
    n_layers = res["n_layers"]
    per_step = LAYER_LINEARS * n_layers
    checks = {
        "tokens_shape": list(toks.shape) == [4, 32],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < 32000)).all()),
        "merge_finite": all(math.isfinite(r["max_abs_diff"])
                            for r in res["merge_check"].values()),
        "path_kernels_launched": all(counts[k] > 0 for k in STATIC_PATH),
        # the merge check's one unmerged prefill and decode step: kernel 3
        # and kernel 4 once per linear, each launch with its rank projection
        "qalora_matmul_per_unmerged_prefill":
            counts["qalora_matmul"] == LAYER_LINEARS * n_layers,
        "qalora_matvec_per_unmerged_decode_step":
            counts["qalora_matvec"] == LAYER_LINEARS * n_layers,
        "rank_proj_per_unmerged_linear":
            counts["qalora_rank_proj"]
            == counts["qalora_matmul"] + counts["qalora_matvec"],
        # 31 decode steps (the first run eagerly as the capture's warm-up,
        # 30 replays) and the merge check's merged decode step
        "gemv_per_decode_step_under_replay":
            counts["qmatvec"] == per_step * SERVE_GEN,
        "decode_captured_once": res["captures"]["serve.decode"][0] == 1,
        "captures_within_budget": all(
            c <= b for c, b in res["captures"].values()),
        "replay_launches_match_profiler": bool(replays) and all(
            r["match"] for r in replays.values()),
        "graphed_and_eager_tokens_identical": same,
    }
    out = {"phase": "serve", **res, "launches": counts,
           "launches_per_prefill": per_step,
           "launches_per_decode_step": per_step,
           "prefill_ms": res["prefill_s"] * 1e3,
           "replay_profiles": replays,
           "walls": walls,
           "peak_mem_gb": peak,
           "depth_cut": "none (all 32 layers)", "checks": checks,
           "sample_tokens": toks[0][:8].tolist()}
    out["ok"] = all(checks.values())
    print(f"[chip_smoke] serve: decode ms a token {walls['graphs']['decode_ms_per_token']:.3f} "
          f"(graphs) / {walls['eager']['decode_ms_per_token']:.3f} (eager); "
          f"captures {res['captures']}", flush=True)
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"serve checks failed: {checks}")
    return counts


# ---------------------------------------------------------------------------
# phase 7: many tenants over one INT4 base, continuous engine
# ---------------------------------------------------------------------------

ADAPTER_TENANTS = ("alice=demo:1", "bob=demo:2", "carol=demo:3")
ADAPTER_ARGV = ["--arch", "llama7b-proxy", "--engine", "continuous",
                "--slots", "4", "--prefill-chunk", "64", "--decode-burst", "8",
                "--prompt-len", "128", "--adapters", ",".join(ADAPTER_TENANTS),
                "--device", "cuda"]


def _engine_walls(torch, want):
    """The continuous path's steady state: phase adapters' model, tenants
    and requests through one engine that replays its steps and one that
    runs them op by op (``eager=True``), each reset between passes, in
    turns.  Returns ({path: {ms a decode model step, ms a ragged step,
    runs}}, streams of every pass equal ``want``)."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousEngine
    cfg = C.get("llama7b-proxy")
    lm, params, _ = serve.build_model(cfg, "cuda")
    store, tenants = serve.build_store(params, ADAPTER_TENANTS)
    cycle = [*tenants, None]
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(want.shape[0], 128)).astype(np.int32)
    engines = {path: ContinuousEngine(
        lm, store.base, n_slots=4, max_len=128 + SERVE_GEN, prefill_chunk=64,
        decode_burst=8, adapters=store, eager=path == "eager")
        for path in ("graphs", "eager")}
    same = []

    def run_pass(path):
        eng = engines[path]
        eng.reset()
        rids = [eng.submit(p, SERVE_GEN, adapter_id=cycle[i % len(cycle)])
                for i, p in enumerate(prompts)]
        out = eng.run()
        torch.cuda.synchronize()
        same.append(bool(np.array_equal(
            np.asarray([out[r] for r in rids], np.int32), want)))
        st = eng.stats
        decode_steps = st.model_steps - 64 * st.ragged_dispatches
        return {"decode_ms_per_step": (st.seconds - st.ragged_seconds) * 1e3
                / max(decode_steps, 1),
                "ragged_ms_per_step": st.ragged_seconds * 1e3
                / max(st.ragged_dispatches, 1),
                "wall_ms": st.seconds * 1e3, "tok_s": st.tok_per_s}

    walls = _in_turns(run_pass)
    walls["captures"] = {p: {g.name: g._cache_size()
                             for g in e.graphs.values()}
                         for p, e in engines.items()}
    del engines, store, lm, params
    _free(torch)
    return walls, all(same)


def phase_adapters(torch):
    """The multi-tenant path at full width and depth.  The engine's launch
    counts are read when it drains (``launches_engine``); the per-tenant
    merge check launches after that and is counted apart.  The engine runs
    under a ``CompileGuard``, which it checks after every iteration."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.runtime.compile_guard import CompileGuard
    serve.main(ADAPTER_ARGV + ["--requests", "4", "--gen-len", "2"])  # warm-up
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with CompileGuard("chip_smoke adapters") as guard:
        res = serve.main(ADAPTER_ARGV + ["--requests", "8", "--gen-len",
                                         str(SERVE_GEN), "--verify"])
        guard_counts = guard.counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = kernels.launches()
    engine = res.pop("launches_engine")
    toks = res.pop("tokens")
    graphs = res.pop("graphs")
    replays = _replay_profiles(torch, graphs)
    del graphs
    _free(torch)
    walls, same = _engine_walls(torch, toks)
    checks_raw = res.pop("tenant_check")
    cross = {name: {ph: r["rel"] for ph, r in c.items()}
             for name, c in res.pop("tenant_cross_check").items()}
    per_step = LAYER_LINEARS * res["n_layers"]
    mixed = res.pop("mixed_check")
    streams = {name: tuple(c["prefill"]["argmax"] + c["decode"]["argmax"])
               for name, c in checks_raw.items()}
    tenant_rel = {name: {ph: r["rel"] for ph, r in c.items()}
                  for name, c in checks_raw.items()}
    checks = {
        "tokens_shape": list(toks.shape) == [8, 32],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < 32000)).all()),
        "slot_launches_per_decode_step":
            engine["qalora_slot_matvec"] == per_step * res["decode_steps"],
        "slot_proj_launches_per_decode_step":
            engine["qalora_slot_rank_proj"] == per_step * res["decode_steps"],
        "tiled_launches_per_ragged_step":
            engine["qmatmul"] == per_step * res["ragged_dispatches"],
        "only_path_kernels": all(v == 0 for k, v in engine.items()
                                 if k not in ADAPTER_PATH),
        "tenants_within_merge_bound": all(
            r <= res["merge_bound_rel"] for t in tenant_rel.values()
            for r in t.values()),
        # each tenant's slot-routed logits are nearer its own merged tree
        # than the next tenant's: the gather served the right adapter
        "tenants_told_apart": all(
            tenant_rel[t][ph] < cross[t][ph] for t in cross
            for ph in tenant_rel[t]),
        # one tree whose rows cycle alice, bob, carol and the null
        # adapter: row i within the bound of its own tenant's merged tree,
        # and nearer it than the next tenant's
        "mixed_rows_routed": all(
            o <= res["merge_bound_rel"] and o < f
            for ph in ("prefill", "decode")
            for o, f in zip(mixed[ph]["rel"], mixed[ph]["next_rel"])),
        # one chunk width, and burst lengths from {1, 2, 4, 8}
        "captures_within_budget": all(
            c <= b for c, b in res["captures"].values())
        and all(c <= b for c, b in guard_counts.values()),
        # the graphed engine declared both steps' budgets
        "guard_declared": set(guard_counts) >= {"engine.ragged",
                                                "engine.burst"},
        "ragged_step_captured": res["captures"]["engine.ragged"][0] == 1,
        "replay_launches_match_profiler": bool(replays) and all(
            r["match"] for r in replays.values()),
        "graphed_and_eager_streams_identical": same,
    }
    out = {"phase": "adapters", **res, "launches": engine,
           "launches_merge_check": {k: total[k] - engine[k] for k in total},
           "launches_per_decode_step": per_step,
           "launches_per_ragged_step": per_step,
           "tenant_rel": tenant_rel, "tenant_cross_rel": cross,
           "mixed_check": mixed,
           # greedy tokens (prefill and one decode step) of the same prompts
           # per tenant: recorded, not checked, since on these random
           # weights the +0.01 nudge sets the argmax whatever the tenant
           # (PERF.md); tenants_told_apart checks the routing
           "streams": {t: list(s) for t, s in streams.items()},
           "same_prompt_streams_differ": len(set(streams.values())) > 1,
           "prefill_ms": res["ragged_s"] * 1e3,
           "ragged_ms_per_step": res["ragged_s"] * 1e3
           / max(res["ragged_dispatches"], 1),
           "decode_ms": res["burst_s"] * 1e3,
           "bank_mb": res["bank_bytes"] / 1e6, "peak_mem_gb": peak,
           "guard": {k: list(v) for k, v in guard_counts.items()},
           "replay_profiles": replays, "walls": walls,
           "depth_cut": "none (all 32 layers)", "checks": checks,
           "sample_tokens": toks[0][:8].tolist()}
    out["ok"] = all(checks.values())
    print(f"[chip_smoke] adapters: ms a decode model step "
          f"{walls['graphs']['decode_ms_per_step']:.3f} (graphs) / "
          f"{walls['eager']['decode_ms_per_step']:.3f} (eager), ms a ragged "
          f"step {walls['graphs']['ragged_ms_per_step']:.3f} / "
          f"{walls['eager']['ragged_ms_per_step']:.3f}; captures (count, "
          f"budget) {res['captures']}", flush=True)
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"adapters checks failed: {checks}")
    return engine


# ---------------------------------------------------------------------------
# phases 8-9: QA-LoRA fine-tuning
# ---------------------------------------------------------------------------

# bf16 keeps 8 significant bits: one rounding is off by at most u = 2**-8
# relative.  The card's step rounds activations, gradients and weights to
# bf16 where the CPU's f32 step does not; a block has ~16 rounding points
# on its forward path and as many on its backward path, so a first-order
# worst case (64 u = 0.25 for a gradient across two blocks) is far above
# what the card shows.  The loss and gradient limits are therefore set
# from the readings of this phase (H100 80GB HBM3, 700 W; the inputs are
# seeded, so a rerun reads the same): loss rel 1.27e-4, gradient rel at
# most 0.080 (median 0.065).  The loss limit is ten times its reading and
# the gradient limit twice its reading, near the median's 2.5x.  Dropping
# the adapter term (every B zeroed) moved the card's loss 2.25e-2 from the
# CPU's: the loss limit sees a forward fault of ~6 % of that term, and the
# phase checks that it still sees the whole term.
BF16_U = 2.0 ** -8
TRAIN_LOSS_TOL = 1.3e-3
TRAIN_GRAD_TOL = 0.16
# Adam's first step moves each element by lr * g / |g| (= +-lr), so two
# updates differ only where the sign of g differs, and a share f of
# flipped elements puts their relative distance at 2 sqrt(f).  A relative
# gradient error eps flips a share arctan(eps) / pi of Gaussian elements:
# 8 % at 64 u; allow one element in eight
TRAIN_FLIP_SHARE = 1 / 8
TRAIN_UPDATE_TOL = 2 * math.sqrt(TRAIN_FLIP_SHARE)
# the updated B (a demo tenant's: rms 0.02) rounds to bf16 (u / 2) and
# moves by 2 lr = 4e-4 where the update flipped
TRAIN_B_RMS, TRAIN_LR = 0.02, 2e-4
TRAIN_B_TOL = (math.sqrt(TRAIN_FLIP_SHARE) * 2 * TRAIN_LR / TRAIN_B_RMS
               + BF16_U / 2)
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
# phase train: the paper's batch of 16 x 256 tokens on alpaca, lr 2e-4,
# max grad norm 0.3 (AdamWConfig's default), 4 steps with a checkpoint
# every 2, then steps 3-4 again from the step-2 checkpoint
TRAIN_ARGV = ["--arch", "llama7b-proxy", "--seq-len", "256",
              "--global-batch", "16", "--dataset", "alpaca", "--lr", "2e-4",
              "--ckpt-every", "2", "--log-every", "1", "--device", "cuda"]
TRAIN_STEPS, TRAIN_RESUME_AT = 4, 2
# the kernels of a train step and of the merge check after it
TRAIN_PATH = ("qalora_matmul", "qalora_rank_proj")
MERGE_PATH = ("qmatmul", "qmatvec", "qalora_matmul", "qalora_matvec",
              "qalora_rank_proj")


def _rel(got, ref):
    """||got - ref|| / ||ref|| in f32 (0 when both are 0)."""
    got, ref = got.float(), ref.to(got.device).float()
    n = ref.norm().item()
    d = (got - ref).norm().item()
    return d / n if n else d


def _adam_first_update(opt, cfg, name):
    """The f32 update AdamW made to ``name`` on its first step (before the
    cast to the parameter's dtype), from the moments it left:
    lr * mu_hat / (sqrt(nu_hat) + eps) at t = 1."""
    mu, nu = opt["mu"][name], opt["nu"][name]
    return cfg.lr * (mu / (1 - cfg.b1)) / (
        (nu / (1 - cfg.b2)).sqrt() + cfg.eps)


def phase_train_small(torch, device="cuda", n_layers=2, seq=128, batch=2,
                      mode="qalora"):
    """One train step of llama7b-proxy at full width and ``n_layers``
    layers (bf16, remat as the config says; the adapters are a seeded demo
    tenant's, so B is nonzero and every gradient is too, where an
    initialised B = 0 gives A none) on the card through the
    kernels, against the same step on the CPU through the plain versions,
    on the same weights upcast to f32 and one batch of ``batch`` x ``seq``
    tokens from the port's stream.  Gradients are read back from the
    first moments (mu = (1 - b1) * clipped g).  ``mode`` lora or qlora
    trains that baseline's adapters (plain products, no port kernel)."""
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.data import make_stream
    from repro_torch.launch.serve import demo_tenant
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, adamw_init, trainable_tensors
    cfg = C.get("llama7b-proxy")
    cfg = cfg.scaled(n_layers=n_layers, quant=dataclasses.replace(
        cfg.quant, mode=mode))
    lm = LM(cfg)
    card = demo_tenant(lm.init(torch.Generator(device=device).manual_seed(0),
                               device), 1)
    cpu = copy.deepcopy(card).to("cpu").float()
    toks, labs = make_stream("alpaca", vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch).next_batch()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, max_grad_norm=0.3)
    step = make_train_fn(lm, opt_cfg)
    # the loss limit's measure: the card's loss with the adapter term
    # dropped (every B zeroed, then restored), before any count is reset
    with torch.no_grad():
        bs = [t for k, t in trainable_tensors(card).items()
              if k.endswith(".b")]
        kept = [t.clone() for t in bs]
        for t in bs:
            t.zero_()
        dropped = float(lm.loss(card, {
            "tokens": torch.as_tensor(toks).to(device),
            "labels": torch.as_tensor(labs).to(device)})[0])
        for t, k in zip(bs, kept):
            t.copy_(k)
        del bs, kept
    sides = {}
    for side, params, dev in (("card", card, device), ("cpu", cpu, "cpu")):
        tr = trainable_tensors(params)
        before = {k: v.detach().clone() for k, v in tr.items()}
        opt = adamw_init(tr)
        batch_t = {"tokens": torch.as_tensor(toks).to(dev),
                   "labels": torch.as_tensor(labs).to(dev)}
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = step(params, opt, batch_t)
        loss = float(m["loss"])
        secs = time.perf_counter() - t0
        gnorm = float(m["grad_norm"])
        clip = min(1.0, opt_cfg.max_grad_norm / max(gnorm, 1e-9))
        sides[side] = {
            "loss": loss, "grad_norm": gnorm, "seconds": secs,
            "launches": kernels.launches(), "tr": tr, "before": before,
            "opt": opt,
            "grad": {k: opt["mu"][k] / (1 - opt_cfg.b1) / clip for k in tr}}
    c, p = sides["card"], sides["cpu"]
    names = list(c["tr"])
    a_names = [k for k in names if k.endswith(".a")]
    b_names = [k for k in names if k.endswith(".b")]
    grad_rel = {k: _rel(c["grad"][k], p["grad"][k]) for k in names}
    upd_rel = {k: _rel(_adam_first_update(c["opt"], opt_cfg, k),
                       _adam_first_update(p["opt"], opt_cfg, k))
               for k in names}
    b_rel = {k: _rel(c["tr"][k], p["tr"][k]) for k in b_names}
    a_moved = sum(int((c["tr"][k] != c["before"][k]).sum()) for k in a_names)
    a_total = sum(c["tr"][k].numel() for k in a_names)
    b_moved = sum(int((c["tr"][k] != c["before"][k]).sum()) for k in b_names)
    b_total = sum(c["tr"][k].numel() for k in b_names)
    per_step = LAYER_LINEARS * n_layers * (2 if cfg.remat else 1) \
        if mode == "qalora" else 0
    loss_rel = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    launches = c["launches"]
    out = {"phase": "train_small", "mode": mode,
           "card": _smi("name,power.limit") if torch.device(device).type
           == "cuda" else "cpu",
           "arch": cfg.name, "n_layers": n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "remat": cfg.remat, "batch": [batch, seq],
           "loss": {"card": c["loss"], "cpu": p["loss"], "rel": loss_rel,
                    "bound": TRAIN_LOSS_TOL,
                    "card_adapters_dropped": dropped,
                    "adapters_dropped_rel":
                        abs(dropped - p["loss"]) / abs(p["loss"])},
           "grad_norm": {"card": c["grad_norm"], "cpu": p["grad_norm"]},
           "grad_rel_max": max(grad_rel.values()),
           "grad_rel_median": sorted(grad_rel.values())[len(names) // 2],
           # all adapter gradients as one vector
           "grad_rel_global": math.sqrt(
               sum((c["grad"][k].cpu() - p["grad"][k]).norm().item() ** 2
                   for k in names)
               / sum(p["grad"][k].norm().item() ** 2 for k in names)),
           "grad_rel_worst": sorted(grad_rel.items(), key=lambda kv: -kv[1])[:4],
           "grad_bound": TRAIN_GRAD_TOL,
           "update_f32_rel_max": {
               "A": max(upd_rel[k] for k in a_names),
               "B": max(upd_rel[k] for k in b_names)},
           "update_bound": TRAIN_UPDATE_TOL,
           "updated_b_rel_max": max(b_rel.values()), "b_bound": TRAIN_B_TOL,
           "card_a_elements_moved_in_bf16": a_moved / a_total,
           "card_b_elements_moved_in_bf16": b_moved / b_total,
           "step_seconds": {"card": c["seconds"], "cpu": p["seconds"]},
           "launches": launches, "launches_expected": per_step}
    checks = {
        "finite": all(math.isfinite(s[k]) for s in (c, p)
                      for k in ("loss", "grad_norm")),
        "loss_within_bound": loss_rel <= TRAIN_LOSS_TOL,
        # the limit is tight enough to see the adapter term dropped
        "loss_limit_sees_adapters_dropped":
            out["loss"]["adapters_dropped_rel"] > TRAIN_LOSS_TOL,
        "grads_within_bound": out["grad_rel_max"] <= TRAIN_GRAD_TOL,
        "f32_updates_within_bound": all(
            v <= TRAIN_UPDATE_TOL for v in out["update_f32_rel_max"].values()),
        "updated_b_within_bound": out["updated_b_rel_max"] <= TRAIN_B_TOL,
        # qalora: kernel 3 and 3a once per linear and once more under
        # remat; lora and qlora launch no port kernel
        "kernel3_per_linear_and_remat": all(
            launches[k] == per_step for k in TRAIN_PATH)
        and all(v == 0 for k, v in launches.items() if k not in TRAIN_PATH),
        "cpu_step_launched_nothing": set(p["launches"].values()) == {0},
    }
    out.update(checks=checks, ok=all(checks.values()))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"train_small checks failed: {checks}")


def _train_linears_at_m(torch, params, m):
    """One layer's 7 ``qalora`` linears of the trained model at the train
    step's M, each held against its plain version, then timed.  Checks,
    each within two bf16 steps of the plain version's max (the tolerance
    of phase kernels): kernel 3 with 3a (``ops.qalora_matmul``, the path's
    call) on the trained adapters; kernel 3 again with a seeded B of rms
    0.01 in place of the trained one, whose adapter term (B moved by
    ~4 lr from 0 in four steps) is far under that tolerance, so that the
    epilogue's ``s t B`` is seen at this M too; and 3a alone on the
    trained A.  Times: kernel 3's forward (with 3a), the plain backward of
    ``_QALoRAMatmul`` (dx, dA, dB) alone, its ``dY dequant(W)^T`` product
    alone, and cuBLAS's ``x @ W`` on the pre-dequantised bf16 weight; ms
    per layer, CUDA events.  Runs after the path's counting window.
    Returns (times, check rows)."""
    from repro_torch.core import schemes
    from repro_torch.kernels import ops
    from repro_torch.kernels.qalora_fused import (
        qalora_matmul_cuda, qalora_matmul_plain, qalora_rank_proj_cuda,
        qalora_rank_proj_plain)
    from repro_torch.kernels.qmatmul import dequant_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    blk = params.blocks[0]
    lps = [blk["attn"][n] for n in ("wq", "wk", "wv", "wo")] + [
        blk["mlp"][n] for n in ("gate", "up", "down")]
    tot = {"kernel3_fwd_ms": 0.0, "plain_bwd_ms": 0.0, "bwd_dx_product_ms": 0.0,
           "cublas_fwd_ms": 0.0}
    rows = []

    def held(name, got, ref, **what):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        tol = 2.0 ** -6 * ref.abs().max().item()
        finite = bool(torch.isfinite(got).all())
        rows.append({"kernel": name, "M": m, **what, "max_abs_err": err,
                     "tol": tol, "finite": finite,
                     "ok": finite and err <= tol})
    for lp in lps:
        qt, ad = schemes.quantized_base(lp), schemes.adapter_params(lp)
        x = torch.randn((m, qt.d_in), generator=gen, device="cuda") \
            .to(torch.bfloat16).requires_grad_(True)
        dy = torch.randn((m, qt.d_out), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        s = lp.policy.s
        kw = dict(s=s, bits=qt.bits, group_size=qt.group_size)
        q = (qt.qweight, qt.scale, qt.zero)
        shape = {"K": qt.d_in, "N": qt.d_out}
        with torch.no_grad():
            xd = x.detach()
            held("qalora_matmul", ops.qalora_matmul(xd, qt, ad, s),
                 qalora_matmul_plain(xd, *q, ad.a, ad.b, **kw),
                 adapters="trained", **shape)
            b_vis = (torch.randn(ad.b.shape, generator=gen, device="cuda")
                     * 0.01).to(ad.b.dtype)
            held("qalora_matmul", qalora_matmul_cuda(xd, *q, ad.a, b_vis, **kw),
                 qalora_matmul_plain(xd, *q, ad.a, b_vis, **kw),
                 adapters="trained A, seeded B", **shape)
            held("qalora_rank_proj",
                 qalora_rank_proj_cuda(xd, ad.a, group_size=qt.group_size),
                 qalora_rank_proj_plain(xd, ad.a, group_size=qt.group_size),
                 adapters="trained A", K=qt.d_in)
            torch.cuda.synchronize()
            del b_vis
            tot["kernel3_fwd_ms"] += _time_ms(
                torch, lambda: ops.qalora_matmul(x, qt, ad, s), [()], 5)
        y = ops.qalora_matmul(x, qt, ad, s)
        tot["plain_bwd_ms"] += _time_ms(
            torch, lambda: torch.autograd.grad(y, (x, ad.a, ad.b), dy,
                                               retain_graph=True), [()], 3)
        w32 = dequant_plain(qt.qweight, qt.scale, qt.zero, qt.bits,
                            qt.group_size, torch.bfloat16).float()
        dyf = dy.float()
        tot["bwd_dx_product_ms"] += _time_ms(torch, lambda: dyf @ w32.T,
                                             [()], 3)
        w16 = w32.to(torch.bfloat16)
        tot["cublas_fwd_ms"] += _time_ms(torch, lambda: xd @ w16, [()], 5)
        del y, w32, w16, dyf
    torch.cuda.empty_cache()
    return tot, rows


def _free(torch):
    """Drop what the deleted model and its closures held on the card."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _link_tree(src, dst):
    """``dst`` as a copy of directory ``src`` made of hard links."""
    import shutil
    shutil.copytree(src, dst, copy_function=os.link)


def phase_train(torch, argv=None, steps=TRAIN_STEPS,
                resume_at=TRAIN_RESUME_AT, prompt_len=128):
    """``repro_torch.launch.train`` on the full llama7b-proxy through its
    own ``setup`` and ``run``: ``steps`` steps with a checkpoint every
    ``resume_at``, counts reset just before the loop and read just after;
    the frozen base bit-identical before and after; B nonzero after step 1;
    the merge of the trained adapters and ``serve.merge_check`` on it; then
    a second run resumed from the step-``resume_at`` checkpoint (hard-link
    copies in a directory of its own), whose losses and adapters must equal
    the uninterrupted run's bit for bit (the same kernels and cuBLAS calls
    at the same shapes, in the same order, on the same values)."""
    import shutil
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import serve, train
    from repro_torch.optim import trainable_tensors
    argv = list(TRAIN_ARGV if argv is None else argv)
    run_a, run_b = (os.path.join(TRAIN_DIR, n) for n in ("run", "resume"))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    try:
        ap = train.build_parser()
        args = ap.parse_args(argv + ["--steps", str(steps), "--ckpt-dir",
                                     run_a])
        t0 = time.perf_counter()
        st = train.setup(args)
        setup_s = time.perf_counter() - t0
        dev = st.device
        frozen_before = {k: v.clone() for k, v in st.params.named_buffers()}
        inner, first = st.step_fn, {}

        def step_fn(params, opt_state, batch):
            metrics = inner(params, opt_state, batch)
            if not first:
                first["b_nonzero"] = all(
                    bool((t != 0).any()) for k, t in st.trainable.items()
                    if k.endswith(".b"))
            return metrics
        st.step_fn = step_fn
        if dev.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        res = train.run(st, args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = kernels.launches()
        base_same = all(torch.equal(frozen_before[k], v)
                        for k, v in st.params.named_buffers())
        del frozen_before
        per_step = LAYER_LINEARS * st.cfg.n_layers * (
            2 if st.cfg.remat else 1)
        step_launches = res["launches"]
        # the merged model against the trained adapter model
        merged = serve.merge_model(st.params)
        prompts = np.random.default_rng(0).integers(
            4, st.cfg.vocab, size=(4, prompt_len)).astype(np.int32)
        kernels.reset_launches()
        mcheck = serve.merge_check(st.lm, st.params, merged, prompts,
                                   prompt_len + 1, device=dev)
        merge_counts = kernels.launches()
        bound = serve.merge_bound(st.cfg)
        trained = {k: v.detach().clone() for k, v in st.trainable.items()}
        m_train = args.global_batch * args.seq_len
        timing, at_m = (_train_linears_at_m(torch, st.params, m_train)
                        if dev.type == "cuda" else ({}, []))
        del merged, st, res["state"], inner, step_fn
        _free(torch)
        # steps resume_at.. again, from the step-resume_at checkpoint
        os.makedirs(run_b)
        for d in ("base", f"step_{resume_at:08d}"):
            _link_tree(os.path.join(run_a, d), os.path.join(run_b, d))
        args_b = ap.parse_args(argv + ["--steps", str(steps), "--ckpt-dir",
                                       run_b])
        st_b = train.setup(args_b)
        kernels.reset_launches()
        res_b = train.run(st_b, args_b)
        counts_b = kernels.launches()
        tr_b = trainable_tensors(st_b.params)
        same_adapters = all(torch.equal(tr_b[k], trained[k]) for k in trained)
        adapter_maxdiff = max((tr_b[k].float() - trained[k].float()).abs()
                              .max().item() for k in trained)
        resumed_steps_ok = all(
            s[k] == per_step for s in res_b["launches"] for k in TRAIN_PATH)
        del st_b, res_b["state"], tr_b, trained
        _free(torch)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    median = res["step_ms_median"]
    layers = res["n_layers"]
    remat = per_step // (LAYER_LINEARS * layers)
    out = {"phase": "train",
           "card": _smi("name,power.limit") if dev.type == "cuda" else "cpu",
           "arch": res["arch"], "n_layers": layers,
           "depth_cut": "none (all 32 layers)",
           "batch": [args.global_batch, args.seq_len], "dataset": args.dataset,
           "lr": args.lr, "steps": steps, "setup_s": setup_s,
           "loss": res["loss"], "grad_norm": res["grad_norm"],
           "step_ms": res["step_ms"], "step_ms_median_after_first": median,
           "tokens_per_s": res["tokens_per_s"],
           "peak_mem_gb": (res["peak_mem_bytes"] or 0) / 1e9,
           "checkpoints": {k: res[k] for k in (
               "base_save_s", "ckpt_snapshot_ms", "ckpt_drain_s")},
           "launches": counts, "launches_per_step": step_launches,
           "launches_expected_per_step": per_step,
           "resumed": {"from_step": resume_at, "loss": res_b["loss"],
                       "step_ms": res_b["step_ms"], "launches": counts_b,
                       "adapters_bit_identical": same_adapters,
                       "adapter_max_abs_diff": adapter_maxdiff},
           "merge_check": mcheck, "merge_bound_rel": bound,
           "merge_launches": merge_counts}
    if timing:
        k3 = timing["kernel3_fwd_ms"] * layers * remat
        bwd = timing["plain_bwd_ms"] * layers
        out["per_layer_ms_at_M"] = {"M": m_train, **timing}
        out["kernels_at_M"] = at_m
        out["step_share"] = {
            "kernel3_ms": k3, "kernel3": k3 / median,
            "plain_bwd_linears_ms": bwd, "plain_bwd_linears": bwd / median,
            "bwd_dx_product_ms": timing["bwd_dx_product_ms"] * layers}
    checks = {
        "losses_finite": all(math.isfinite(x) for x in res["loss"]),
        "base_bit_identical": base_same,
        "b_nonzero_after_step_1": bool(first.get("b_nonzero")),
        "kernel3_and_3a_per_step": all(
            s[k] == per_step for s in step_launches for k in TRAIN_PATH),
        "no_other_kernel_in_a_step": all(
            v == 0 for s in step_launches for k, v in s.items()
            if k not in TRAIN_PATH),
        "path_kernels_launched": all(counts[k] > 0 for k in TRAIN_PATH),
        "resumed_losses_identical": res_b["loss"] == res["loss"][resume_at:],
        "resumed_kernel3_and_3a_per_step": resumed_steps_ok,
        "resumed_adapters_identical": same_adapters,
        "merge_within_bound": all(r["rel"] <= bound for r in mcheck.values()),
        "merge_path_kernels_launched": all(
            merge_counts[k] > 0 for k in MERGE_PATH),
        # kernel 3 and 3a against their plain versions at the step's M
        "kernel3_and_3a_at_train_M_within_bound":
            dev.type != "cuda" or (
                {r["kernel"] for r in at_m} == set(TRAIN_PATH)
                and all(r["ok"] for r in at_m)),
    }
    out.update(checks=checks, ok=all(checks.values()))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"train checks failed: {checks}")
    errs = {k: max(r["max_abs_err"] for r in at_m if r["kernel"] == k)
            for k in TRAIN_PATH} if at_m else {}
    return counts, errs


# ---------------------------------------------------------------------------
# phase 10: the paper's quantizers and baselines
# ---------------------------------------------------------------------------

# calibration activations of each D_in (4096, 11008): 2048 rows, each
# feature scaled by a lognormal factor (a few features far larger than the
# rest, as in an LLM's activations); one GPTQ Hessian per D_in
CALIB_ROWS = 2048
# GPTQ on the card against the CPU: W[:, :256] of layer 0's wq (GPTQ's
# D_out columns are independent, so the slice is exact); the share of
# identical codes, and no code more than one level apart
GPTQ_CPU_COLS = 256
GPTQ_SAME_SHARE = 0.9999
# QLoRA's fine-tune: launch/train.py on the converted model, 2 steps of
# 4 x 256 tokens
QLORA_ARGV = ["--arch", "llama7b-proxy", "--mode", "qlora", "--seq-len",
              "256", "--global-batch", "4", "--dataset", "alpaca", "--lr",
              "2e-4", "--steps", "2", "--log-every", "1", "--device", "cuda"]
HEAD_POLICY = "*=int4,lm_head=int4"
HEAD_K, HEAD_N = 4096, 32000
# the kernels of a served PTQ model (merged: no adapter)
PTQ_PATH = ("qmatmul", "qmatvec")
LAYER_NAMES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))


def _serve_static(torch, lm, merged, prompts, params=None):
    """``merged`` served statically (prefill, then ``SERVE_GEN`` greedy
    tokens by replaying the captured decode step): a first pass captures
    the step, a second is counted and timed; with ``params`` (the adapter
    model) ``serve.merge_check`` against ``merged`` runs inside the
    counting window too.  Then one replay of the captured step under
    ``torch.profiler``."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import serve
    max_len = prompts.shape[1] + SERVE_GEN
    gen = serve.make_graph_generator(lm, merged, prompts.shape, SERVE_GEN,
                                     max_len, device="cuda")
    first, _ = gen(prompts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    toks, times = gen(prompts)
    check = (serve.merge_check(lm, params, merged, prompts, max_len,
                               device="cuda") if params is not None else None)
    torch.cuda.synchronize()
    counts = kernels.launches()
    replays = _replay_profiles(torch, {"decode": gen.graphs})
    del gen
    _free(torch)
    return {"tokens": toks, "same_tokens_both_passes":
            bool(np.array_equal(first, toks)),
            "decode_ms_per_token": times["decode_s"] * 1e3 / (SERVE_GEN - 1),
            "prefill_ms": times["prefill_s"] * 1e3, "launches": counts,
            "merge_check": check, "replay_profiles": replays}


def _hold_intq_linears(torch, blk, gen):
    """Kernels 1 (M = 512) and 2 (M = 4) on one layer's merged ``intq``
    linears against their plain versions (two bf16 steps of the plain
    version's max)."""
    from repro_torch.core import schemes
    from repro_torch.kernels.qmatmul import qmatmul_cuda, qmatmul_plain
    from repro_torch.kernels.qmatvec import qmatvec_cuda, qmatvec_plain
    rows = []
    for grp, name in LAYER_NAMES:
        qt = schemes.quantized_base(blk[grp][name])
        args = (qt.qweight, qt.scale, qt.zero)
        kw = dict(bits=qt.bits, group_size=qt.group_size)
        for kern, plain, m in ((qmatmul_cuda, qmatmul_plain, TILED_M),
                               (qmatvec_cuda, qmatvec_plain, GEMV_M)):
            x = torch.randn((m, qt.d_in), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            y, ref = kern(x, *args, **kw).float(), plain(x, *args, **kw).float()
            err = (y - ref).abs().max().item()
            tol = 2.0 ** -6 * ref.abs().max().item()
            rows.append({"kernel": kern.__name__.replace("_cuda", ""),
                         "linear": f"{grp}/{name}", "M": m, "K": qt.d_in,
                         "N": qt.d_out, "scale_dtype": str(qt.scale.dtype),
                         "max_abs_err": err, "tol": tol,
                         "ok": bool(torch.isfinite(y).all()) and err <= tol})
    return rows


def _replay_ms(torch, graph, iters=SERVE_GEN - 1):
    """Device time of one replay of a captured decode step (CUDA events
    around ``iters`` replays): the steady state's cost of one token."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _window_checks(counts, n_lin, head=False, merge_check=True):
    """The launch checks of one static serve window over ``n_lin`` block
    linears (and a quantized head with ``head``): kernel 2 once per linear
    of the ``SERVE_GEN - 1`` replayed decode steps and of the merge
    check's merged decode step; kernel 1 once per block linear of each
    merged prefill (the generator's, and the merge check's two); with the
    merge check, kernel 3 once per block linear of its unmerged prefill and
    kernel 4 once per linear of its unmerged decode step, each with its
    rank projection.  A prefill's logits are its last token's, so the head
    sees M = 4 rows there: kernel 4 (unmerged) or 2 (merged), not 3 or
    1."""
    per_step = n_lin + int(head)
    merged_prefills = 3 if merge_check else 1
    out = {"gemv_per_decode_step_under_replay": counts["qmatvec"]
           == per_step * (SERVE_GEN - 1 + int(merge_check))
           + int(head) * merged_prefills,
           "tiled_per_merged_prefill":
               counts["qmatmul"] == n_lin * merged_prefills}
    if merge_check:
        out.update({
            "qalora_matmul_per_unmerged_prefill":
                counts["qalora_matmul"] == n_lin,
            "qalora_matvec_per_unmerged_decode_step":
                counts["qalora_matvec"] == per_step + int(head),
            "rank_proj_per_unmerged_linear": counts["qalora_rank_proj"]
            == counts["qalora_matmul"] + counts["qalora_matvec"]})
    else:
        out["no_adapter_kernel"] = all(
            v == 0 for k, v in counts.items() if k not in PTQ_PATH)
    return out


def phase_baselines(torch):
    """The paper's contrast at full llama7b-proxy size (32 layers, int4
    g32 r64, bf16), on a float stand-in base drawn from seed 0: GPTQ over
    all 224 linears into a QA-LoRA model, served with its merge check;
    the same base converted to QLoRA (NF4), fine-tuned 2 steps by
    ``launch/train.py``, merged to a float model (the '4+16' row) and
    post-training quantized (RTN and GPTQ) into an INT4 model served
    through kernels 1 and 2, its logits held beside the QA-LoRA merge's;
    a model with a quantized ``lm_head`` (``--policy "*=int4,lm_head=int4"``)
    served through ``launch/serve.py``; one lora and one qlora train step
    of 2-layer llama7b-proxy on the card against the CPU.  Returns the
    launch counts of its three serve windows and the kernel rows at the
    head's shape."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.core import gptq, quant, schemes
    from repro_torch.launch import serve, train
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    cfg = C.get("llama7b-proxy")
    pol = cfg.quant
    lm = LM(cfg)
    n_lin = LAYER_LINEARS * cfg.n_layers
    walls, checks = {}, {}
    out = {"phase": "baselines",
           "card": _smi("name,power.limit"), "arch": cfg.name,
           "n_layers": cfg.n_layers, "depth_cut": "none (all 32 layers)",
           "policy": f"int{pol.bits} g{pol.group_size} r{pol.rank}, "
                     f"{str(pol.dtype).replace('torch.', '')} scales"}

    def tick(key, t0):
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0

    # 1. the float stand-in base and the calibration Hessians
    t0 = time.perf_counter()
    fp = LM(cfg.scaled(quant=dataclasses.replace(pol, mode="fp"))).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    calib = {}
    for d in (cfg.d_model, cfg.d_ff):
        scale = torch.exp(torch.randn(d, generator=gen, device="cuda"))
        calib[d] = torch.randn((CALIB_ROWS, d), generator=gen,
                               device="cuda") * scale
    hess = {d: gptq.hessian_from_inputs(x) for d, x in calib.items()}
    tick("fp_base_and_hessians_s", t0)

    def gptq_closure(w):
        return gptq.gptq_quantize(w, hess[w.shape[0]], pol.bits,
                                  pol.group_size, scale_dtype=pol.scale_dtype)

    # 2. GPTQ over every linear, then GPTQ against RTN on layer 0
    t0 = time.perf_counter()
    qmodel = schemes.convert_tree(
        fp, pol, generator=torch.Generator(device="cuda").manual_seed(1),
        quantizer=gptq_closure)
    tick("gptq_convert_s", t0)
    gptq.release_graphs()
    schemes_seen = sorted(lp.scheme for lp in qmodel.modules()
                          if schemes.is_linear(lp))
    mse = []
    for grp, name in LAYER_NAMES:
        w = schemes.dense_view(fp.blocks[0][grp][name], torch.float32)
        x = calib[w.shape[0]]
        ref = x @ w
        rtn = quant.quantize(w, pol.bits, pol.group_size,
                             scale_dtype=pol.scale_dtype)
        e = {}
        for key, qt in (("gptq", schemes.quantized_base(
                qmodel.blocks[0][grp][name])), ("rtn", rtn)):
            e[key] = ((x @ quant.dequantize(qt) - ref) ** 2).mean().item()
        mse.append({"linear": f"{grp}/{name}", "K": w.shape[0],
                    "N": w.shape[1], "gptq_mse": e["gptq"],
                    "rtn_mse": e["rtn"], "gptq_over_rtn": e["gptq"] / e["rtn"]})
        del w, ref, rtn
    w = schemes.dense_view(fp.blocks[0]["attn"]["wq"],
                           torch.float32)[:, :GPTQ_CPU_COLS].contiguous()
    t0 = time.perf_counter()
    on_card = gptq_closure(w)
    tick("gptq_card_slice_s", t0)
    t0 = time.perf_counter()
    on_cpu = gptq.gptq_quantize(w.cpu(), hess[w.shape[0]].cpu(), pol.bits,
                                pol.group_size, scale_dtype=pol.scale_dtype)
    walls["gptq_cpu_slice_s"] = time.perf_counter() - t0
    ca = quant.unpack(on_card.qweight, pol.bits).cpu().to(torch.int32)
    cb = quant.unpack(on_cpu.qweight, pol.bits).to(torch.int32)
    card_cpu = {"linear": "blocks/0/attn/wq", "columns": GPTQ_CPU_COLS,
                "codes": ca.numel(),
                "same_share": (ca == cb).double().mean().item(),
                "max_level_diff": int((ca - cb).abs().max()),
                "scale_max_rel_diff": ((on_card.scale.cpu().float()
                                        - on_cpu.scale.float()).abs().max()
                                       / on_cpu.scale.float().abs().max())
                .item()}
    # the lazy-batch form against the reference's unblocked recursion on
    # the whole of that linear, on the card: time and identical codes
    w = schemes.dense_view(fp.blocks[0]["attn"]["wq"], torch.float32)
    form = {"linear": "blocks/0/attn/wq", "K": w.shape[0], "N": w.shape[1]}
    codes = {}
    for key, block in (("lazy", gptq.BLOCK), ("unblocked", w.shape[0])):
        # a first call captures the block's graph, the second replays it
        gptq.gptq_quantize(w, hess[w.shape[0]], pol.bits, pol.group_size,
                           scale_dtype=pol.scale_dtype, block=block)
        t0 = time.perf_counter()
        qt = gptq.gptq_quantize(w, hess[w.shape[0]], pol.bits, pol.group_size,
                                scale_dtype=pol.scale_dtype, block=block)
        tick(f"gptq_{key}_one_linear_s", t0)
        form[f"{key}_s"] = walls.pop(f"gptq_{key}_one_linear_s")
        codes[key] = quant.unpack(qt.qweight, pol.bits).to(torch.int32)
        gptq.release_graphs()
    form["block"] = gptq.BLOCK
    form["same_share"] = (codes["lazy"] == codes["unblocked"]).double() \
        .mean().item()
    form["max_level_diff"] = int((codes["lazy"] - codes["unblocked"]).abs()
                                 .max())
    del calib, w, on_card, on_cpu, codes, qt
    print(f"[chip_smoke] baselines: GPTQ over "
          f"{schemes_seen.count('qalora')} linears "
          f"in {walls['gptq_convert_s']:.1f} s; GPTQ/RTN output MSE on "
          f"layer 0: {[round(r['gptq_over_rtn'], 3) for r in mse]}; card vs "
          f"CPU codes identical {card_cpu['same_share']:.6f}; one 4096 x 4096 "
          f"linear lazy-batch {form['lazy_s']:.2f} s, unblocked "
          f"{form['unblocked_s']:.2f} s", flush=True)
    checks.update({
        # the head stays fp: a uniform policy never quantizes it
        "gptq_every_linear": schemes_seen == ["fp"] * int(
            not cfg.tie_embeddings) + ["qalora"] * n_lin,
        "gptq_at_or_below_rtn_each_linear": all(
            r["gptq_mse"] <= r["rtn_mse"] for r in mse),
        "gptq_card_cpu_same_share": card_cpu["same_share"]
        >= GPTQ_SAME_SHARE,
        "gptq_card_cpu_within_one_level": card_cpu["max_level_diff"] <= 1,
        "gptq_lazy_as_unblocked": form["same_share"] >= GPTQ_SAME_SHARE
        and form["max_level_diff"] <= 1})

    # 3. the GPTQ model served, with its merge check
    serve.bump_adapters(qmodel)
    merged = serve.merge_model(qmodel)
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(4, 128)).astype(np.int32)
    g = _serve_static(torch, lm, merged, prompts, params=qmodel)
    gen = torch.Generator(device="cuda").manual_seed(11)
    held = _hold_intq_linears(torch, merged.blocks[0], gen)
    bound = serve.merge_bound(cfg)
    qalora_rel = max(r["rel"] for r in g["merge_check"].values())
    print(f"[chip_smoke] baselines: GPTQ model, {g['decode_ms_per_token']:.3f}"
          f" ms a token, tokens {g['tokens'][0][:8].tolist()}, merge check "
          f"{qalora_rel:.2e} of max|logit| (bound {bound}); launches "
          f"{g['launches']}", flush=True)
    checks.update({f"gptq_serve_{k}": v for k, v in
                   _window_checks(g["launches"], n_lin).items()})
    checks.update({
        "gptq_merge_within_bound": qalora_rel <= bound,
        "gptq_tokens_in_vocab": bool(((g["tokens"] >= 0)
                                      & (g["tokens"] < cfg.vocab)).all()),
        "gptq_serve_same_tokens_both_passes": g["same_tokens_both_passes"],
        "gptq_replay_launches_match_profiler": all(
            r["match"] for r in g["replay_profiles"].values()),
        "gptq_layer0_kernels_1_2_within_tol": all(r["ok"] for r in held)})
    del qmodel, merged
    _free(torch)

    # 4. QLoRA: NF4, 2 train steps, the 4+16 merge, PTQ (RTN and GPTQ)
    t0 = time.perf_counter()
    ql = schemes.convert_tree(
        fp, dataclasses.replace(pol, mode="qlora"),
        generator=torch.Generator(device="cuda").manual_seed(2))
    tick("nf4_convert_s", t0)
    del fp
    _free(torch)
    args = train.build_parser().parse_args(QLORA_ARGV)
    st = train.setup(args, params=ql)
    kernels.reset_launches()
    tr = train.run(st, args)
    train_launches = kernels.launches()
    del st, tr["state"]
    m416 = serve.merge_model(ql)
    del ql
    _free(torch)
    ptq_pol = dataclasses.replace(pol, mode="intq")
    t0 = time.perf_counter()
    ptq_rtn = schemes.convert_tree(m416, ptq_pol)
    tick("ptq_rtn_convert_s", t0)
    t0 = time.perf_counter()
    ptq_gptq = schemes.convert_tree(m416, ptq_pol, quantizer=gptq_closure)
    tick("ptq_gptq_convert_s", t0)
    gptq.release_graphs()
    del hess
    max_len = prompts.shape[1] + SERVE_GEN
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    nxt = lm.prefill(m416, {"tokens": toks})[0].argmax(-1).to(torch.int32)
    ref = serve._two_steps(lm, m416, toks, nxt, max_len, torch.float32,
                           "cuda")
    gap = {}
    for key, tree in (("rtn", ptq_rtn), ("gptq", ptq_gptq)):
        got = serve._two_steps(lm, tree, toks, nxt, max_len, torch.float32,
                               "cuda")
        gap[key] = {ph: serve._compare(got[ph], ref[ph]) for ph in ref}
    del ref, m416, ptq_rtn
    _free(torch)
    p = _serve_static(torch, lm, ptq_gptq, prompts)
    del ptq_gptq
    _free(torch)
    ptq_rel = {k: max(r["rel"] for r in v.values()) for k, v in gap.items()}
    print(f"[chip_smoke] baselines: QLoRA 4+16 -> PTQ logit gap "
          f"{ptq_rel['gptq']:.3e} (GPTQ) / {ptq_rel['rtn']:.3e} (RTN) of "
          f"max|logit|, beside the QA-LoRA merge's {qalora_rel:.3e}; PTQ "
          f"model {p['decode_ms_per_token']:.3f} ms a token, tokens "
          f"{p['tokens'][0][:8].tolist()}; NF4 {walls['nf4_convert_s']:.1f}"
          f" s, train steps {[round(x, 1) for x in tr['step_ms']]} ms",
          flush=True)
    checks.update({f"ptq_serve_{k}": v for k, v in _window_checks(
        p["launches"], n_lin, merge_check=False).items()})
    checks.update({
        "qlora_train_losses_finite": all(math.isfinite(x)
                                         for x in tr["loss"]),
        "qlora_train_no_port_kernel": set(train_launches.values()) == {0},
        "ptq_serve_same_tokens_both_passes": p["same_tokens_both_passes"],
        "ptq_serve_kernels_1_2_launched": all(
            p["launches"][k] > 0 for k in PTQ_PATH),
        "ptq_replay_launches_match_profiler": all(
            r["match"] for r in p["replay_profiles"].values()),
        "ptq_gap_finite": all(math.isfinite(v) for v in ptq_rel.values()),
        # the paper's contrast: PTQ of the 4+16 model is lossy, QA-LoRA's
        # merge is not
        "ptq_gap_above_qalora_merge": min(ptq_rel.values()) > qalora_rel})

    # 5. a quantized lm_head, through launch/serve.py
    argv = ["--arch", "llama7b-proxy", "--requests", "4", "--prompt-len",
            "128", "--device", "cuda", "--policy", HEAD_POLICY, "--gen-len",
            str(SERVE_GEN), "--verify"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    res = serve.main(argv)
    torch.cuda.synchronize()
    head_launches = kernels.launches()
    walls["head_serve_s"] = time.perf_counter() - t0
    graphs = res.pop("graphs")
    head_replays = _replay_profiles(torch, graphs)
    head_ms = _replay_ms(torch, next(iter(graphs["decode"].graphs.values())))
    del graphs
    _free(torch)
    head_per_step = n_lin + 1
    head_rel = max(r["rel"] for r in res["merge_check"].values())
    gen = torch.Generator(device="cuda").manual_seed(13)
    head_rows = {name: _check_one(torch, name, KERNELS[name][1], HEAD_K,
                                  HEAD_N, BITS, gen, timing=True)
                 for name in ("qmatmul", "qmatvec", "qalora_matmul",
                              "qalora_matvec")}
    print(f"[chip_smoke] baselines: lm_head=int4, {head_per_step} linears a "
          f"step, {head_ms:.3f} ms a token (replay), merge check "
          f"{head_rel:.2e}; head rows at K={HEAD_K} N={HEAD_N} (ms kernel / "
          f"plain / bound): " + ", ".join(
              f"{n} {r['kernel_ms']:.3f}/{r['plain_ms']:.3f}/"
              f"{r['bound_ms']:.3f}" for n, r in head_rows.items()),
          flush=True)
    checks.update({f"head_serve_{k}": v for k, v in _window_checks(
        head_launches, n_lin, head=True).items()})
    checks.update({
        "head_merge_within_bound": head_rel <= res["merge_bound_rel"],
        "head_decode_captured_once": res["captures"]["serve.decode"][0] == 1,
        "head_replay_launches_match_profiler": bool(head_replays) and all(
            r["match"] for r in head_replays.values()),
        "head_rows_within_tol": all(r["ok"] for r in head_rows.values())})
    head_toks = res.pop("tokens")

    # 6. one lora and one qlora step on the card against the CPU
    for mode in ("lora", "qlora"):
        phase_train_small(torch, mode=mode)
    walls["phase_s"] = time.perf_counter() - t_phase
    out.update({
        "walls_s": walls, "gptq_vs_rtn_layer0": mse,
        "gptq_card_vs_cpu": card_cpu, "gptq_forms": form,
        "calibration_rows": CALIB_ROWS,
        "gptq_model": {k: v for k, v in g.items() if k != "tokens"}
        | {"sample_tokens": g["tokens"][0][:8].tolist()},
        "gptq_layer0_kernel_rows": held, "merge_bound_rel": bound,
        "qlora_train": {k: tr[k] for k in ("loss", "grad_norm", "step_ms",
                                           "peak_mem_bytes")},
        "ptq_logit_gap_vs_4_16": gap, "qalora_merge_rel": qalora_rel,
        "ptq_model": {k: v for k, v in p.items() if k != "tokens"}
        | {"sample_tokens": p["tokens"][0][:8].tolist()},
        "head_model": {"policy": HEAD_POLICY, "linears_a_step": head_per_step,
                       "launches": head_launches,
                       "replay_profiles": head_replays,
                       "decode_ms_per_token_replay": head_ms,
                       "decode_ms_per_token_first_run":
                           res["decode_ms_per_token"],
                       "prefill_ms": res["prefill_s"] * 1e3,
                       "merge_check": res["merge_check"],
                       "sample_tokens": head_toks[0][:8].tolist()},
        "checks": checks, "ok": all(checks.values())})
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"baselines checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return ({"gptq serve": g["launches"], "ptq serve": p["launches"],
             "lm_head=int4 serve": head_launches}, head_rows)


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
        rows, ragged = phase_kernels(torch)
        flash_rows, flash_launches = phase_flash(torch)
        phase_small(torch)
        counts = phase_serve(torch)
        counts = {k: counts[k] for k in STATIC_PATH}
        counts.update({k: v for k, v in phase_adapters(torch).items()
                       if k not in STATIC_PATH})
        phase_train_small(torch)
        train_counts, train_errs = phase_train(torch)
        base_counts, head_rows = phase_baselines(torch)
    except Exception as e:  # report, save and fail: no result line
        import traceback
        traceback.print_exc()
        RECORD["error"] = repr(e)
        save()
        return 1
    summary = []
    design = next(p for p in RECORD["phases"] if p["phase"] == "build")[
        "design"]
    for name, (kind, m, source, replaces) in KERNELS.items():
        r = rows[name]
        head = head_rows.get(name)
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[name] + train_counts.get(name, 0)
            + sum(c[name] for c in base_counts.values()),
            "max_abs_err": max([x["max_abs_err"]
                                for x in r + ragged.get(name, [])]
                               + [train_errs.get(name, 0.0)]
                               + ([head["max_abs_err"]] if head else [])),
            "ms": _per_layer(r, "kernel_ms"),
            "plain_ms": _per_layer(r, "plain_ms"),
            "bound_ms": _per_layer(r, "bound_ms"),
            "bound_by": r[1]["bound_by"],
            "library_ms": _per_layer(r, "library_ms"),
            "work": f"one layer's linears at M={m}: 4x(4096,4096) + "
                    f"2x(4096,11008) + 1x(11008,4096), int4 g32, bf16"
                    + (f", ids {SLOT_IDS[m]} over a {SLOT_BANK_ROWS}-row "
                       f"bank" if kind == "slot" else ""),
            "launches_path": "continuous multi-tenant serve (phase "
                             "adapters)" if name not in STATIC_PATH
                             else "static serve (phase serve)",
            "status": "ported, checked"})
        if name in STATIC_PATH:
            summary[-1]["launches_by_path"] = {
                "static serve (phase serve)": counts[name],
                f"train, {TRAIN_STEPS} steps (phase train)":
                    train_counts[name],
                **{f"{path} (phase baselines)": c[name]
                   for path, c in base_counts.items()}}
        if head:
            summary[-1]["lm_head"] = {
                "work": f"the lm_head at M={m}, K={HEAD_K}, N={HEAD_N}, "
                        f"int4 g32, bf16 (phase baselines)",
                **{key: head[key] for key in (
                    "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")}}
        if name in ragged:
            rr = ragged[name]
            summary[-1]["ragged_step"] = {
                "work": f"the same linears at M={RAGGED_M} (phase adapters)",
                **{f"{key}_ms": _per_layer(rr, f"{key}_ms") for key in (
                    "kernel", "plain", "library", "bound")}}
            if name == "qmatmul":
                summary[-1]["ragged_step"]["with_bank_delta_ms"] = \
                    _per_layer(rr, "slot_tiled_ms")
        if name in design:
            summary[-1]["design"] = design[name]
        elif name in PTXAS_ENTRY:
            summary[-1]["ptxas"] = _ptxas(name)
        if m <= GEMV_MAX_M:
            summary[-1]["timing"] = "CUDA-graph replay"
            summary[-1]["eager_ms"] = _per_layer(r, "kernel_eager_ms")
            summary[-1]["library_eager_ms"] = _per_layer(r,
                                                         "library_eager_ms")
    r = rows[PROJ[0]]
    summary.append({
        "name": PROJ[0], "route": "cuda", "source": PROJ[1],
        "replaces": PROJ[2],
        "launches": counts[PROJ[0]] + train_counts[PROJ[0]]
        + sum(c[PROJ[0]] for c in base_counts.values()),
        "launches_by_path": {
            "static serve (phase serve)": counts[PROJ[0]],
            f"train, {TRAIN_STEPS} steps (phase train)":
                train_counts[PROJ[0]],
            **{f"{path} (phase baselines)": c[PROJ[0]]
               for path, c in base_counts.items()}},
        "max_abs_err": max([x["max_abs_err"] for x in r + ragged[PROJ[0]]]
                           + [train_errs[PROJ[0]]]),
        **{f"{key}_ms": _per_layer(r, f"{key}_ms")
           for key in ("plain", "library")},
        "ms": _per_layer(r, "kernel_ms"), "bound_ms": _per_layer(r, "bound_ms"),
        "bound_by": r[0]["bound_by"],
        "work": f"kernel 3's first launch, t = bf16(pool_g(x) @ A), for one "
                f"layer's linears at M={TILED_M}: 6 at K=4096, 1 at "
                f"K=11008, r {RANK}",
        "launches_path": "static serve (phase serve): one per kernel 3 and "
                         "kernel 4 launch",
        "status": "ported, checked (part of kernels 3 and 4)",
        "ptxas": _ptxas(PROJ[0]),
        "ragged_step": {f"{key}_ms": _per_layer(ragged[PROJ[0]], f"{key}_ms")
                        for key in ("kernel", "library", "bound")},
        "gemv": {"work": f"kernel 4's first launch, one row of x a block, "
                         f"at M={GEMV_M}",
                 "ptxas": _ptxas("qalora_rank_proj_gemv"),
                 "max_abs_err": max(x["max_abs_err"]
                                    for x in ragged["gemv_proj"]),
                 **{f"{key}_ms": _per_layer(ragged["gemv_proj"], f"{key}_ms")
                    for key in ("kernel", "plain", "library", "bound")}}})
    r = rows[SLOT_PROJ[0]]
    summary.append({
        "name": SLOT_PROJ[0], "route": "cuda", "source": SLOT_PROJ[1],
        "replaces": SLOT_PROJ[2], "launches": counts[SLOT_PROJ[0]],
        "max_abs_err": max(x["max_abs_err"] for x in r),
        **{f"{key}_ms": _per_layer(r, f"{key}_ms")
           for key in ("plain", "library")},
        "ms": _per_layer(r, "kernel_ms"), "bound_ms": _per_layer(r, "bound_ms"),
        "bound_by": r[0]["bound_by"],
        "work": f"kernel 5's first launch, t[i] = bf16(pool_g(x[i]) @ "
                f"A[ids[i]]), for one layer's linears at M={GEMV_M}, ids "
                f"{SLOT_IDS[GEMV_M]} over a {SLOT_BANK_ROWS}-row bank: 6 at "
                f"K=4096, 1 at K=11008, r {RANK}",
        "launches_path": "continuous multi-tenant serve (phase adapters): "
                         "one per kernel 5 launch",
        "status": "ported, checked (part of kernel 5)",
        "ptxas": _ptxas(SLOT_PROJ[0])})
    llama = flash_rows[0]
    summary.append({
        "name": "flash_mha", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": llama["kernel_ms"], "plain_ms": llama["plain_ms"],
        "bound_ms": llama["bound_ms"], "bound_by": llama["bound_by"],
        "library_ms": llama["library_ms"],
        "library": f"scaled_dot_product_attention, fastest backend: "
                   f"{llama['library_backend']}",
        "work": "causal attention, bf16, llama7b-proxy: B 4, S 2048, "
                "32 heads, d 128",
        "launches_path": "phase flash (no served path calls it, as in the "
                         "JAX package)",
        "status": "ported, checked; redesigned (wgmma, TMA ring)",
        "design": llama["design"],
        "ptxas": next(p for p in RECORD["phases"]
                      if p["phase"] == "flash")["ptxas_wgmma"],
        "rows": {r["row"]: {key: r[key] for key in (
            "design", "kernel_ms", "plain_ms", "library_ms",
            "library_backend", "library_default_ms", "bound_ms", "bound_by",
            "max_abs_err", "row_err_ratio")} for r in flash_rows}})
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
