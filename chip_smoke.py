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
   weights on the CPU (plain versions); then a reduced mixtral-8x22b (4
   experts, top-2, a prompt of two 16-position routing chunks) the same
   way, its prefill logits at every position compared over the tokens
   routed alike at every layer on both sides, with the share of flipped
   (token, layer) routings.
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
8. paged   -- the continuous engine on the paged KV cache: 8 requests of a
   shared 96-token prefix + 32 own tokens (32 generated) on 4 slots in
   16-token pages from a 31-page pool (the contiguous capacity is 41)
   through a graphed contiguous, a graphed paged and an eager paged
   engine: tokens equal, the reused prompt tokens those a model-free run
   of the scheduler and page table predicts, admission backed off at
   least once, kernels 1 and 2 counted, the two graphed engines in turns
   for their ms a step, each engine's memory; then phase adapters'
   tenants through ``serve --page-size 16``, tokens phase adapters'.
9. spec    -- self-speculation: ``serve --speculate 3 --draft-policy
   "*=intq8"`` counted (kernel 1 at the verify step's M = 16 and in the
   drafter's ride-along, kernel 2 in the draft steps) and one replay of
   each graph profiled; then a plain graphed engine, the ``*=intq8`` and
   ``*=intq2`` drafters, a paged one and a drafter from another seed (its
   drafts rejected) in turns for their ms a committed token, tokens
   plain decode's; kernels 1 and 2 held at the drafters' bits.
10. frontend -- ``repro_torch.serving.ServingFrontend`` on the full
   llama7b-proxy (4 slots, chunks of 64, bursts of 4), each frontend's
   engine warmed (every step captured) before it serves.  (a) Recovery,
   synchronous: 12 requests through a plain engine, a clean frontend
   and one with a crash at dispatch 3 and a NaN poisoning at dispatch 7:
   every ticket FINISHED, tokens identical to the clean run and the plain
   engine's, exactly 2 recoveries whose log names only ``InjectedFault``
   and ``EngineCorrupted``, no capture after the warm-up, and launches of
   kernels 1 and 2 exactly 224 a committed model step plus the poisoned
   dispatch's own (read at each iteration's start by a step hook); then
   phase adapters' tenants on a paged engine with one crash, tokens equal
   to the same engine unfaulted and to phase adapters', kernels 1, 5 and
   5a counted.  (b) Live SLO runs on the serve thread, after the
   reference's ``slo_bench``: 32 requests, queue cap 8, offered at 0.7 x
   the capacity of a saturated calibration run, total deadline 3 x its
   slowest latency; Poisson and bursty (6) arrivals, each clean and with a
   crash at dispatch 8 and stragglers.  Prints each run's TTFT and TPOT
   p50/p95/p99, timeout and reject rates, goodput and recoveries, the
   frontend's own host ms a dispatch, and the device's idle share of a
   fifth, clean Poisson run under ``torch.profiler``.  Gates: no FAILED
   ticket, recoveries equal to the injected crashes, every ticket's tokens
   a prefix of the plain engine's stream (the whole stream when
   FINISHED), no capture inside a measured run, every serve thread ended.
11. train_small -- one QA-LoRA train step (``repro_torch.launch.steps``)
   of llama7b-proxy at full width and 2 layers, bf16, remat on, on a
   batch of 2 x 128 tokens from the port's stream: on the card through
   kernel 3 and its projection (twice per linear: once more when remat
   recomputes the block), against the same step on the CPU through the
   plain versions on the same weights upcast to f32; the loss and each
   adapter gradient within limits set from the H100's readings, the f32
   updates of A and B and the updated B within bounds argued from bf16's
   8-bit significand; and, as the loss limit's measure, how far the card's
   loss moves with every B zeroed (the adapter term dropped).
12. train    -- ``repro_torch.launch.train``'s own ``setup`` and ``run`` on
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
13. baselines -- the paper's contrast at full llama7b-proxy size, on a
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
   (as phase 11).
14. families -- the other dense gqa configs and the gqa_moe family at
   their published widths, random weights from seed 0, bf16, int4 g32
   r64: h2o-danube-1.8b (24 layers, head_dim 80, window 4096) and
   starcoder2-7b (32 layers, non-gated GELU MLP) at full depth,
   deepseek-67b at 16 of 95 layers and mixtral-8x22b (8 experts top-2,
   moe_d_ff 16384) at 8 of 56 (phases moe_* run it at 16).  Each served
   statically, 4 x (128 + 32), the decode step replayed (one capture
   within its budget, under a ``CompileGuard``), a counted pass with the
   merge check and then further passes for the medians of decode ms a
   token and prefill ms,
   beside their floors (the bytes of every linear and of the cache over
   3.35 TB/s; the prefill's operations, mixtral's experts at their
   capacity buffers, over 989 TFLOP/s).  Kernels 1-4 launch exactly
   linears a layer (from the config: 7, 6, 7, 28) x layers x steps, and
   each held against its plain version on block 0 at the rows the path
   gives it (attention and the dense MLP at every token of the step,
   mixtral's expert 0 at its capacity: 160 in prefill, 80 in a ragged
   step, 2 in decode); the merge check within ``serve.merge_bound``
   (mixtral: over the tokens whose routing agreed at every layer in both
   models, at least ``FAMILY_AGREE_MIN`` of them with at most
   ``FAMILY_FLIP_MAX`` of the (token, layer) routings flipped; the
   largest flipped gap reported; and a negative control, the merge check
   again with the merged experts' outputs times (1 + f x seeded noise)
   for f of 2^-8 to 2^-2, which the same rule must reject from
   ``FAMILY_FAULT_REJECT`` up).  For
   h2o-danube-1.8b and mixtral, the continuous engine on 8 requests of
   64/96/128 + 16/32/24 tokens over 4 slots (chunks of 64, bursts of 8),
   contiguous and paged in 16-token pages: each graphed engine warmed
   then counted (kernel 1 linears x ragged steps, kernel 2 linears x
   decode steps, captures within budget), an eager engine of each layout
   with the graphed streams; mixtral's dropped share of routed
   assignments a step over all routed rows and over the real ones, the
   padding rows' share of the kept capacity, a per-expert histogram and
   the share of real rows routed as another of their step, from the
   eager run's routing.
15. moe_train -- mixtral-8x22b fine-tuned at its published widths and 16
   of 56 layers through ``launch/train.py``'s ``setup`` and ``run`` (bf16,
   int4 g32 r64, remat, ``--n-layers 16``): 4 steps of 8 x 256 tokens of
   alpaca at lr 2e-5, one routing group of 2048 rows a step, so each
   expert's capacity is C = 640; kernel 3 and its projection 2 x 448
   times a step (attention at M = 2048, each expert at M = 640) and no
   other kernel;
   loss = xent + 0.01 aux each step; the base's fingerprint unchanged;
   step wall (median after the first), tokens/s, peak memory beside the
   operations floor; the first step's dropped share; the trainer starts
   from the nudged adapters of phase families, and the merge check of
   the trained adapters routes >= 95 % of the tokens alike at every layer,
   within ``serve.merge_bound`` over them, a gate the base with its
   adapters dropped must fail (phase families' flip limit of 1 % a
   reading, and the untrained adapters' merge); kernels 3 and 3a held
   against their plain versions and timed at the step's shapes (the
   experts at M = 640, K x N = 6144 x 16384 and 16384 x 6144); a fifth
   step under ``torch.profiler`` (device busy, idle share,
   kernel 3 / 3a / PyTorch matmuls / the rest).  Then phase train's
   cut-and-resume at 2 layers from the trainer's own start (B = 0; steps
   3-4 from the step-2 checkpoint bit for bit, the base identical; the
   card's merge check a reading, the same merge in f32 on the CPU routed
   alike and within 1e-2 of the adapter term), and phase train_small's
   card-vs-CPU step on a 2-layer mixtral, the CPU routing each token as
   the card did (``moe.choose_experts``; its own top-2 recorded: where it
   differs, a near tie, a limit that a planted misrouting must exceed),
   gradients, loss, xent and aux at phase train_small's bounds.
16. moe_serve -- mixtral at 16 layers self-speculating (k = 3, one
   ``*=intq2`` drafter tree): a plain graphed engine and speculating ones,
   contiguous and paged, 8 requests of 64/96/128 + 16/32/24 tokens on 4
   slots, the contiguous one counted against the launches its stats
   predict (kernel 1 in the ragged steps and the verify step's attention,
   kernel 2 on the verify step's experts at C = 5 and in the drafter steps
   at C = 2), the three one timed pass each for their ms a committed
   token and acceptance, each speculating layout again eager with equal
   streams, paged equal to contiguous unless the pool backed off;
   kernel 2 held at M = 5 (4 bits) and M = 2 (2 bits) on expert 0.  Then
   mixtral (16 layers) and h2o-danube-1.8b (whole) behind
   ``ServingFrontend``: phase frontend's recovery runs (a crash at dispatch
   3, a NaN at 7; exact launch counts; h2o's tokens equal to the clean run
   and the plain engine, mixtral's clean run equal to the plain engine and
   its recovered run equal to the clean one up to what each request had
   committed when the first fault hit: a recovered request is prefilled
   again in another batch, and capacity routing depends on the batch),
   then the calibration and one clean Poisson SLO run at 0.7 x capacity
   under ``torch.profiler`` (TTFT and TPOT p50/p99, goodput, idle share).
17. the ``kernels`` summary, and the final ``{"ok": true, ...}`` line.

Any failed phase exits non-zero before the final line.  Without a card,
or without the repository's ``src`` beside this file, it exits non-zero
and prints no result.  Writes everything also to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
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
# which of phase frontend's counted runs launch each kernel: kernels 1 and
# 2 on the merged model, kernels 1, 5 and 5a on the tenants
FRONTEND_PATH = {
    "qmatmul": "the frontend's recovery, tenants' recovery and SLO runs",
    "qmatvec": "the frontend's recovery and SLO runs",
    "qalora_slot_matvec": "the frontend's tenants' recovery"}

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


def _step_linears(cfg) -> int:
    """Quantized linears a model step of ``cfg`` launches a kernel for,
    counted from the config (``LM.layer_linears``: 7 a gated dense layer,
    6 with starcoder2's non-gated MLP, 4 + 3 x 8 for mixtral, whose
    router is fp) times its layers."""
    from repro_torch.models.lm import LM
    return LM(cfg).layer_linears() * cfg.n_layers


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
    out["moe"] = _small_moe(torch, pol)
    if not out["moe"]["ok"]:
        emit({**out, "ok": False})
        raise AssertionError(f"small gqa_moe: {out['moe']}")
    emit({**out, "ok": True, "bound_rel": 5e-2})


def _small_moe(torch, pol):
    """Reduced mixtral-8x22b (4 experts, top-2, two routing chunks of 16)
    in bf16: the card's prefill logits at every position against the
    CPU's, over the tokens routed alike at every layer on both sides (the
    two sides round differently, which may flip a near tie of the router),
    with the share of flipped (token, layer) routings."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.launch.serve import (bump_adapters, compare_routed,
                                          merge_model, routing_agreement)
    from repro_torch.models.lm import LM
    from repro_torch.models.moe import record_routing
    cfg = C.reduced("mixtral-8x22b", quant=pol)
    lm = LM(cfg)
    params = bump_adapters(lm.init(torch.Generator().manual_seed(0), "cpu"))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, size=(2, 32)).astype(np.int32))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_experts": cfg.n_experts, "moe_chunk": cfg.moe_chunk,
           "bound_rel": 5e-2}
    for which, p in (("adapter", params), ("merged", merge_model(params))):
        with record_routing() as cpu_routes:
            cpu_logits, _ = lm.prefill_all(p, {"tokens": prompts})
        gpu = copy.deepcopy(p).to("cuda")
        with record_routing() as gpu_routes:
            gpu_logits, _ = lm.prefill_all(gpu, {"tokens": prompts.cuda()})
        gpu_routes = [{k: v.cpu() for k, v in r.items()} for r in gpu_routes]
        same = routing_agreement(gpu_routes, cpu_routes)
        out[which] = compare_routed(gpu_logits.cpu(), cpu_logits, same)
        del gpu
    out["ok"] = all(out[w]["rel"] <= 5e-2 and _routed_alike(out[w])
                    for w in ("adapter", "merged"))
    return out


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
    from repro_torch.launch.profile_serve import _device_us, _kind
    out = {}
    for step in graphs.values():
        for key, g in step.graphs.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                g.replay()
                torch.cuda.synchronize()
            seen, kernels_run, by_kind = {}, 0, {}
            for evt in prof.key_averages():
                if evt.device_type.name != "CUDA":
                    continue
                kernels_run += evt.count
                kind = _kind(evt.key)
                by_kind[kind] = by_kind.get(kind, 0.0) + _device_us(evt) / 1e3
                name = _counter_of(evt.key)
                if name is not None:
                    seen[name] = seen.get(name, 0) + evt.count
            out[f"{step.name}{list(key[:2])}"] = {
                "launches": dict(g.launches), "profiler": seen,
                "device_kernels": kernels_run,
                "device_ms_by_kind": by_kind,
                "device_busy_ms": sum(by_kind.values()),
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
    per_step = res["linears_per_layer"] * n_layers
    checks = {
        "tokens_shape": list(toks.shape) == [4, 32],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < 32000)).all()),
        "merge_finite": all(math.isfinite(r["max_abs_diff"])
                            for r in res["merge_check"].values()),
        "path_kernels_launched": all(counts[k] > 0 for k in STATIC_PATH),
        # the merge check's one unmerged prefill and decode step: kernel 3
        # and kernel 4 once per linear, each launch with its rank projection
        "qalora_matmul_per_unmerged_prefill":
            counts["qalora_matmul"] == per_step,
        "qalora_matvec_per_unmerged_decode_step":
            counts["qalora_matvec"] == per_step,
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
    per_step = res["linears_per_layer"] * res["n_layers"]
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
    return engine, toks


# ---------------------------------------------------------------------------
# phase 8: the continuous engine on the paged KV cache
# ---------------------------------------------------------------------------

# 8 requests of a shared 96-token prefix plus 32 tokens of their own, each
# generating 32, on 4 slots in pages of 16 tokens.  A request holds
# ceil(160 / 16) = 10 pages, so the contiguous capacity is 4 x 10 + 1
# pages; the pool holds 31 (30 usable): three requests fit at first, the
# fourth backs off until pages free up
PAGE_SIZE = 16
PAGED_SHARED, PAGED_OWN, PAGED_REQUESTS = 96, 32, 8
PAGED_N_PAGES = 31


def _predicted_reuse(trace, n_slots, max_len, chunk, page_size, n_pages):
    """The prompt tokens the page table reuses on ``trace`` (no EOS), with
    the engine's admission order: the scheduler and its page table driven
    without a model, one row a decode step (a burst never outruns the
    shortest request, so slots free, and admissions happen, at the same
    model steps as one step at a time)."""
    import numpy as np
    from repro_torch.serving import PageTable, Request, Scheduler
    pt = PageTable(n_pages, page_size, -(-max_len // page_size))
    sch = Scheduler(n_slots, max_len, chunk, page_table=pt)
    for r in trace:
        sch.submit(Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                           rid=r.rid))
    while sch.has_work:
        sch.admit()
        sch.plan()
        sch.commit(np.zeros((n_slots,), np.int32))
    return pt.reused_tokens_total


def _cache_gb(eng):
    return sum(t.numel() * t.element_size() for c in eng._caches()
               for t in (*c["layers"].values(), c["len"],
                         *([c["pages"]] if "pages" in c else []))) / 1e9


def _engine_pass(torch, eng, trace):
    """One drained run of ``eng`` from a reset: (tokens by rid, stats, the
    run's peak device memory above what was allocated at its start, GB)."""
    eng.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, rid=r.rid)
    out = eng.run()
    torch.cuda.synchronize()
    return out, eng.stats, (torch.cuda.max_memory_allocated() - start) / 1e9


def _built_engines(torch, make, trace):
    """Engines from ``make`` ({name: constructor}), each built and run once
    (the captures, the warm-up) before the next is built.  Returns
    ({name: engine}, {name: first pass}, {name: the device memory the
    engine holds after its first pass (caches, graph pool, staging),
    allocated and reserved, GB})."""
    engines, first, held = {}, {}, {}
    for name, build in make.items():
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        engines[name] = build()
        first[name] = _engine_pass(torch, engines[name], trace)
        held[name] = {
            "allocated_gb": (torch.cuda.memory_allocated() - a0) / 1e9,
            "reserved_gb": (torch.cuda.memory_reserved() - r0) / 1e9}
    return engines, first, held


def _step_walls(st, chunk, n_requests):
    """Decode ms a model step and a committed token, ragged ms a step."""
    decode_steps = st.model_steps - chunk * st.ragged_dispatches
    decode_ms = (st.seconds - st.ragged_seconds) * 1e3
    return {"decode_ms_per_step": decode_ms / max(decode_steps, 1),
            "decode_ms_per_token": decode_ms
            / max(st.tokens_out - n_requests, 1),
            "ragged_ms_per_step": st.ragged_seconds * 1e3
            / max(st.ragged_dispatches, 1),
            "wall_ms": st.seconds * 1e3}


def phase_paged(torch, adapter_toks):
    """The paged cache at full width and depth: the shared-prefix trace
    through a graphed contiguous engine, a graphed paged one (a pool under
    the contiguous capacity) and an eager paged one, under a
    ``CompileGuard``; counts are reset just before the paged engine's
    counted run and read just after.  Then the graphed engines in turns
    for their step times, and phase adapters' tenants through
    ``launch/serve.py --page-size``, whose tokens must be phase adapters'."""
    from statistics import median
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.runtime.compile_guard import CompileGuard
    from repro_torch.serving import ContinuousEngine, make_trace
    t_phase = time.perf_counter()
    cfg = C.get("llama7b-proxy")
    lm, _, merged = serve.build_model(cfg, "cuda")
    trace = make_trace(PAGED_REQUESTS, cfg.vocab, seed=0,
                       prompt_lens=(PAGED_OWN,), gen_lens=(SERVE_GEN,),
                       shared_prefix=PAGED_SHARED)
    max_len = PAGED_SHARED + PAGED_OWN + SERVE_GEN
    kw = dict(n_slots=RAGGED_SLOTS, max_len=max_len,
              prefill_chunk=RAGGED_CHUNK, decode_burst=8)
    predicted = _predicted_reuse(trace, RAGGED_SLOTS, max_len, RAGGED_CHUNK,
                                 PAGE_SIZE, PAGED_N_PAGES)
    paged = dict(page_size=PAGE_SIZE, n_pages=PAGED_N_PAGES, **kw)
    with CompileGuard("chip_smoke paged") as guard:
        engines, first, held = _built_engines(torch, {
            "contiguous": lambda: ContinuousEngine(lm, merged, **kw),
            "paged": lambda: ContinuousEngine(lm, merged, **paged),
            "paged_eager": lambda: ContinuousEngine(lm, merged, eager=True,
                                                    **paged)}, trace)
        kernels.reset_launches()
        out, st, _ = _engine_pass(torch, engines["paged"], trace)
        torch.cuda.synchronize()
        counts = kernels.launches()
        pt = engines["paged"].page_table
        pt.check_invariants()
        runs = {"contiguous": [], "paged": []}
        for order in (("contiguous", "paged"), ("paged", "contiguous")):
            for name in order:
                o, s, peak = _engine_pass(torch, engines[name], trace)
                runs[name].append({"same": o == first["contiguous"][0],
                                   "pass_peak_gb": peak,
                                   "busy_slot_steps": s.busy_slot_steps,
                                   **_step_walls(s, RAGGED_CHUNK,
                                                 PAGED_REQUESTS)})
        guard_counts = guard.counts()
    captures = {name: {g.name: g._cache_size() for g in e.graphs.values()}
                for name, e in engines.items()}
    replays = _replay_profiles(torch, engines["paged"].graphs)
    per_step = _step_linears(cfg)
    decode_steps = st.model_steps - RAGGED_CHUNK * st.ragged_dispatches
    walls = {name: {key: median(r[key] for r in rs) for key in rs[0]
                    if key != "same"} for name, rs in runs.items()}
    cache_gb = {name: _cache_gb(e) for name, e in engines.items()}
    del engines, lm, merged
    _free(torch)

    # phase adapters' tenants and requests on the paged layout, through
    # the serve CLI, counted on their own
    kernels.reset_launches()
    with CompileGuard("chip_smoke paged adapters") as guard_t:
        res = serve.main(ADAPTER_ARGV + ["--requests", "8", "--gen-len",
                                         str(SERVE_GEN), "--page-size",
                                         str(PAGE_SIZE)])
        guard_t_counts = guard_t.counts()
    tenant_toks = res.pop("tokens")
    tenant_counts = res.pop("launches_engine")
    res.pop("graphs")
    _free(torch)
    cont_toks = first["contiguous"][0]
    checks = {
        "tokens_equal_contiguous_graphed": out == cont_toks,
        "tokens_equal_paged_eager": first["paged_eager"][0] == cont_toks,
        "every_pass_same_tokens": all(first[n][0] == cont_toks
                                      for n in first)
        and all(r["same"] for rs in runs.values() for r in rs),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for v in out.values()
                               for t in v),
        "every_request_done": sorted(len(v) for v in out.values())
        == [SERVE_GEN] * PAGED_REQUESTS,
        "reused_tokens_as_predicted": pt.reused_tokens_total == predicted
        and predicted > 0,
        "admission_backed_off": pt.alloc_backoffs >= 1,
        "pool_drained": pt.n_used == 0,
        "fewer_rows_than_contiguous": walls["paged"]["busy_slot_steps"]
        < walls["contiguous"]["busy_slot_steps"],
        "tiled_launches_per_ragged_step":
            counts["qmatmul"] == per_step * st.ragged_dispatches,
        "gemv_launches_per_decode_step":
            counts["qmatvec"] == per_step * decode_steps,
        "only_path_kernels": all(v == 0 for k, v in counts.items()
                                 if k not in PTQ_PATH),
        "captures_within_budget": all(c <= b for c, b in
                                      guard_counts.values())
        and all(c <= b for c, b in guard_t_counts.values())
        and all(c <= b for c, b in res["captures"].values()),
        "replay_launches_match_profiler": bool(replays) and all(
            r["match"] for r in replays.values()),
        "tenants_paged_equal_contiguous": bool(np.array_equal(
            tenant_toks, adapter_toks)),
        "tenants_slot_launches_per_decode_step":
            tenant_counts["qalora_slot_matvec"]
            == tenant_counts["qalora_slot_rank_proj"]
            == per_step * res["decode_steps"],
        "tenants_tiled_launches_per_ragged_step":
            tenant_counts["qmatmul"] == per_step * res["ragged_dispatches"],
        "tenants_only_path_kernels": all(
            v == 0 for k, v in tenant_counts.items()
            if k not in ADAPTER_PATH),
    }
    out_rec = {
        "phase": "paged", "arch": cfg.name, "n_layers": cfg.n_layers,
        "requests": PAGED_REQUESTS,
        "prompt": f"{PAGED_SHARED} shared + {PAGED_OWN} own tokens",
        "gen_len": SERVE_GEN, "slots": RAGGED_SLOTS,
        "prefill_chunk": RAGGED_CHUNK, "page_size": PAGE_SIZE,
        "n_pages": PAGED_N_PAGES,
        "contiguous_pages": RAGGED_SLOTS * -(-max_len // PAGE_SIZE) + 1,
        "reused_tokens_total": pt.reused_tokens_total,
        "reused_tokens_predicted": predicted,
        "alloc_backoffs": pt.alloc_backoffs, "peak_pages_used": pt.peak_used,
        "launches": counts, "decode_steps": decode_steps,
        "ragged_dispatches": st.ragged_dispatches, "walls": walls,
        "runs": runs, "cache_gb": cache_gb, "engine_memory": held,
        "captures": captures,
        "guard": {k: list(v) for k, v in guard_counts.items()},
        "replay_profiles": replays,
        "tenants": {"launches": tenant_counts, **{k: res[k] for k in (
            "reused_tokens_total", "alloc_backoffs", "peak_pages_used",
            "decode_steps", "ragged_dispatches", "captures")}},
        "phase_s": time.perf_counter() - t_phase,
        "depth_cut": "none (all 32 layers)", "checks": checks}
    out_rec["ok"] = all(checks.values())
    print(f"[chip_smoke] paged: ms a decode model step "
          f"{walls['paged']['decode_ms_per_step']:.3f} (paged) / "
          f"{walls['contiguous']['decode_ms_per_step']:.3f} (contiguous), "
          f"ms a ragged step {walls['paged']['ragged_ms_per_step']:.3f} / "
          f"{walls['contiguous']['ragged_ms_per_step']:.3f}; busy slot "
          f"rows {walls['paged']['busy_slot_steps']:.0f} / "
          f"{walls['contiguous']['busy_slot_steps']:.0f}; engine memory "
          f"{held['paged']['allocated_gb']:.3f} / "
          f"{held['contiguous']['allocated_gb']:.3f} GB (cache "
          f"{cache_gb['paged']:.3f} / {cache_gb['contiguous']:.3f}); "
          f"reused {pt.reused_tokens_total} (predicted {predicted}), "
          f"backoffs {pt.alloc_backoffs}", flush=True)
    emit(out_rec)
    if not out_rec["ok"]:
        raise AssertionError(f"paged checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return counts, tenant_counts


# ---------------------------------------------------------------------------
# phase 9: self-speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 3
SPEC_DRAFTERS = ("*=intq8", "*=intq2")
# on these random weights every stream soon cycles through two tokens, so
# any copy of the model drafts them right; a drafter from another seed
# drafts wrong, and its rounds reject and roll back
SPEC_OTHER_SEED = 1
SPEC_OTHER = f"seed-{SPEC_OTHER_SEED} model"
SPEC_REQUESTS = 4
SPEC_ARGV = ["--arch", "llama7b-proxy", "--engine", "continuous", "--slots",
             "4", "--prefill-chunk", "64", "--prompt-len", "128",
             "--requests", str(SPEC_REQUESTS), "--gen-len", str(SERVE_GEN),
             "--speculate", str(SPEC_K), "--device", "cuda"]


def phase_spec(torch):
    """Self-speculation at full width and depth: ``launch/serve.py
    --speculate 3 --draft-policy "*=intq8"`` counted (reset just before,
    read just after) under a ``CompileGuard``, one replay of each graph
    under ``torch.profiler``; then the same prompts through a plain graphed
    engine (bursts of 8), a speculating engine per drafter and one on the
    paged layout, in turns for their ms a committed token; kernel 1 at the
    verify step's M and kernels 1 and 2 at each drafter's bits held
    against their plain versions."""
    from statistics import median
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.runtime.compile_guard import CompileGuard
    from repro_torch.serving import ContinuousEngine, Request
    t_phase = time.perf_counter()
    kernels.reset_launches()
    with CompileGuard("chip_smoke spec") as guard:
        res = serve.main(SPEC_ARGV + ["--draft-policy", SPEC_DRAFTERS[0]])
        guard_counts = guard.counts()
    torch.cuda.synchronize()
    counts = res.pop("launches_engine")
    spec_toks = res.pop("tokens")
    replays = _replay_profiles(torch, res.pop("graphs"))
    _free(torch)

    cfg = C.get("llama7b-proxy")
    lm, _, merged = serve.build_model(cfg, "cuda")
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(SPEC_REQUESTS, 128)).astype(np.int32)
    trace = [Request(prompt=p, max_new_tokens=SERVE_GEN, rid=i)
             for i, p in enumerate(prompts)]
    kw = dict(n_slots=RAGGED_SLOTS, max_len=128 + SERVE_GEN + SPEC_K,
              prefill_chunk=RAGGED_CHUNK)
    spec = dict(decode_burst=1, speculate=SPEC_K, **kw)
    other = serve.build_model(cfg, "cuda", seed=SPEC_OTHER_SEED)[2]
    make = {"plain": lambda: ContinuousEngine(lm, merged, decode_burst=8,
                                              **kw)}
    for drafter in SPEC_DRAFTERS:
        make[drafter] = (lambda d=drafter: ContinuousEngine(
            lm, merged, drafter=d, **spec))
    make["paged " + SPEC_DRAFTERS[0]] = lambda: ContinuousEngine(
        lm, merged, drafter=SPEC_DRAFTERS[0], page_size=PAGE_SIZE, **spec)
    make[SPEC_OTHER] = lambda: ContinuousEngine(lm, merged, drafter=other,
                                                **spec)
    with CompileGuard("chip_smoke spec engines") as guard_e:
        engines, first, held_mem = _built_engines(torch, make, trace)
        runs = {n: [] for n in engines}
        for order in (list(engines), list(engines)[::-1]):
            for name in order:
                o, s, _ = _engine_pass(torch, engines[name], trace)
                runs[name].append({
                    "same": o == first["plain"][0],
                    "acceptance_rate": s.acceptance_rate,
                    "dispatches": s.dispatches,
                    **_step_walls(s, RAGGED_CHUNK, SPEC_REQUESTS)})
        guard_e_counts = guard_e.counts()
    plain = np.asarray([first["plain"][0][i] for i in range(SPEC_REQUESTS)],
                       np.int32)
    walls = {n: {key: median(r[key] for r in rs) for key in rs[0]
                 if key != "same"} for n, rs in runs.items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    held = {"target, verify M": _hold_intq_linears(
        torch, merged.blocks[0], gen, tiled_m=RAGGED_SLOTS * (SPEC_K + 1))}
    for drafter in SPEC_DRAFTERS:
        held[drafter] = _hold_intq_linears(
            torch, engines[drafter].draft_params.blocks[0], gen,
            tiled_m=RAGGED_M)
    stats = {n: {"acceptance_rate": e.stats.acceptance_rate,
                 "proposed_tokens": e.stats.proposed_tokens,
                 "accepted_tokens": e.stats.accepted_tokens}
             for n, e in engines.items()}
    del engines, lm, merged, other
    _free(torch)
    per_step = _step_linears(cfg)
    rounds = res["decode_steps"] // (SPEC_K + 1)
    profiled = {key.split("[")[0]: r for key, r in replays.items()}
    checks = {
        "tokens_equal_plain_graphed": bool(np.array_equal(spec_toks, plain)),
        "every_pass_same_tokens": all(first[n][0] == first["plain"][0]
                                      for n in first)
        and all(r["same"] for rs in runs.values() for r in rs),
        "tokens_in_vocab": bool(((plain >= 0) & (plain < cfg.vocab)).all()),
        "draft_proposed": res["proposed_tokens"] > 0,
        # the verify step at M = 4 x (k + 1) = 16: kernel 1 once a linear;
        # the target's and the drafter's ragged steps at M = 256 too
        "tiled_launches": counts["qmatmul"]
        == per_step * (2 * res["ragged_dispatches"] + rounds),
        # k + 1 drafter steps a round, kernel 2 once a linear each
        "gemv_launches_per_round": counts["qmatvec"]
        == per_step * (SPEC_K + 1) * rounds,
        "only_path_kernels": all(v == 0 for k, v in counts.items()
                                 if k not in PTQ_PATH),
        "verify_graph_runs_kernel_1": profiled.get("engine.verify", {}).get(
            "profiler") == {"qmatmul": per_step},
        "draft_graph_runs_kernel_2": profiled.get("engine.draft", {}).get(
            "profiler") == {"qmatvec": per_step * (SPEC_K + 1)},
        "replay_launches_match_profiler": bool(replays) and all(
            r["match"] for r in replays.values()),
        "captures_within_budget": all(c <= b for c, b in
                                      guard_counts.values())
        and all(c <= b for c, b in guard_e_counts.values())
        and all(c <= b for c, b in res["captures"].values()),
        "guard_declared": set(guard_counts) >= {
            "engine.ragged", "engine.draft", "engine.verify"},
        "kernels_held": all(r["ok"] for rows in held.values()
                            for r in rows),
        # the other seed's drafts: most rejected, rolled back, and the
        # streams still plain decode's
        "mismatched_drafter_rejects": stats[SPEC_OTHER]["accepted_tokens"]
        < stats[SPEC_OTHER]["proposed_tokens"] / 2,
    }
    out = {"phase": "spec", "arch": cfg.name, "n_layers": cfg.n_layers,
           "speculate": SPEC_K, "requests": SPEC_REQUESTS,
           "prompt_len": 128, "gen_len": SERVE_GEN, "slots": RAGGED_SLOTS,
           "main_run": {k: res[k] for k in (
               "drafter", "acceptance_rate", "proposed_tokens",
               "accepted_tokens", "dispatches", "decode_steps",
               "ragged_dispatches", "captures", "decode_ms_per_step",
               "tokens_out")},
           "launches": counts, "rounds": rounds, "walls": walls,
           "runs": runs, "stats": stats, "engine_memory": held_mem,
           "guard": {k: list(v) for k, v in guard_counts.items()},
           "replay_profiles": replays, "held": held,
           "phase_s": time.perf_counter() - t_phase,
           "acceptance_note": "random weights: acceptance is a property "
                              "of these weights, not of a trained model",
           "depth_cut": "none (all 32 layers)", "checks": checks,
           "sample_tokens": plain[0][:8].tolist()}
    out["ok"] = all(checks.values())
    print("[chip_smoke] spec: ms a committed token "
          + ", ".join(f"{n} {w['decode_ms_per_token']:.3f}"
                      + (f" (acceptance {stats[n]['acceptance_rate']:.2f})"
                         if n != "plain" else "")
                      for n, w in walls.items()), flush=True)
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"spec checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return counts, held


# ---------------------------------------------------------------------------
# phase 10: the fault-tolerant serving frontend
# ---------------------------------------------------------------------------

# the frontend's engine: 4 slots, prefill chunks of 64, decode bursts of 4
FE_ENGINE = dict(n_slots=RAGGED_SLOTS, prefill_chunk=RAGGED_CHUNK,
                 decode_burst=4)
# (a) recovery: 12 requests, a crash at dispatch 3 (before its admission)
# and a NaN poisoning at dispatch 7 (the step runs, its health bit trips)
FE_TRACE = dict(seed=3, prompt_lens=(64, 96, 128), gen_lens=(16, 32, 24))
FE_REQUESTS = 12
FE_FAULTS = dict(seed=0, crash_steps=(3,), nan_steps=(7,))
# phase adapters' tenants on the paged engine, one crash mid-decode
FE_TENANT_FAULTS = dict(seed=0, crash_steps=(5,))
# (b) the live SLO runs, after the reference's slo_bench
# (benchmarks/run.py:715-797): 32 requests, queue cap 8, offered at 0.7 x
# the saturated capacity, total deadline 3 x the saturated run's slowest
# end-to-end latency; Poisson and bursty (6) arrivals, clean and faulty
SLO_TRACE = dict(seed=0, prompt_lens=(32, 64, 128), gen_lens=(16, 32, 48))
SLO_REQUESTS = 32
SLO_QUEUE_CAP = 8
SLO_LOAD = 0.7
SLO_BURST = 6
SLO_FAULTS = dict(seed=2, crash_steps=(8,), p_straggle=0.05, straggle_s=0.01)
JOIN_S = 300.0  # a serve thread that outlives this fails the phase


def _graph_captures(eng):
    return {g.name: g._cache_size() for g in eng.graphs.values()}


def _detached(eng, fn):
    """``fn()`` with the engine's step hook detached (an injector's
    schedule then starts at the measured run)."""
    hook, eng.step_hook = eng.step_hook, None
    try:
        return fn()
    finally:
        eng.step_hook = hook


def _warm(torch, fe):
    """Capture every step the frontend's engine can replay before it
    serves: a lone request of 32 tokens per burst length of the ladder
    (generating 2**i + 1 tokens bursts 2**i at once after its prefill),
    which also captures the ragged step; then ``reset()``, which keeps the
    graphs.  Returns the captures, each at its budget."""
    import numpy as np
    eng = fe.engine

    def passes():
        for i in range(eng.decode_burst.bit_length()):
            eng.submit(np.full(32, 5, np.int32), (1 << i) + 1)
            eng.run()
    _detached(eng, passes)
    eng.reset()
    torch.cuda.synchronize()
    caps = _graph_captures(eng)
    if caps != eng.budgets:
        raise AssertionError(f"warm-up captured {caps}, budgets "
                             f"{eng.budgets}")
    return caps


class _LaunchProbe:
    """A step hook: the kernel launch counts and each live request's
    emitted token count at each engine iteration's start, then the
    injector (if any).  ``per_dispatch(i)`` is what iteration i
    launched."""

    def __init__(self, injector=None):
        self.injector = injector
        self.snaps = []
        self.emitted = []

    def __call__(self, engine):
        from repro_torch import kernels
        self.snaps.append(kernels.launches())
        self.emitted.append({s.req.rid: len(s.emitted)
                             for s in engine.sched.slots if s is not None})
        if self.injector is not None:
            self.injector(engine)

    def per_dispatch(self, i, end):
        nxt = self.snaps[i + 1] if i + 1 < len(self.snaps) else end
        return {k: nxt[k] - self.snaps[i][k] for k in nxt
                if nxt[k] != self.snaps[i][k]}


def _engine_streams(lm, params, trace, **kw):
    """The plain continuous engine's greedy stream per request."""
    from repro_torch.serving import ContinuousEngine
    eng = ContinuousEngine(lm, params, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng.run()


def _fault_kinds(fe):
    return sorted({e.split("(")[0] for _, e in fe.fault_log})


def _frontend_recovery(torch, cfg, lm, merged):
    """(a): the trace through a plain engine, a clean frontend and one
    with a crash and a NaN poisoning, synchronously; counts reset just
    before each frontend's run and read just after."""
    from repro_torch import kernels
    from repro_torch.runtime import FaultInjector
    from repro_torch.serving import ServingFrontend, make_trace
    trace = make_trace(FE_REQUESTS, cfg.vocab, **FE_TRACE)
    kw = dict(FE_ENGINE, max_len=max(FE_TRACE["prompt_lens"])
              + max(FE_TRACE["gen_lens"]))
    plain = _engine_streams(lm, merged, trace, **kw)
    _free(torch)
    per_step = _step_linears(cfg)
    runs = {}
    for name, inj in (("clean", None),
                      ("faulty", FaultInjector(**FE_FAULTS))):
        probe = _LaunchProbe(inj)
        fe = ServingFrontend(lm, merged, queue_cap=len(trace),
                             injector=probe, **kw)
        warm = _warm(torch, fe)
        kernels.reset_launches()
        t0 = time.perf_counter()
        for r in trace:
            fe.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id, rid=r.rid)
        fe.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        est = fe.engine_stats
        decode_steps = est.model_steps - RAGGED_CHUNK * est.ragged_dispatches
        pred = {"qmatmul": per_step * est.ragged_dispatches,
                "qmatvec": per_step * decode_steps}
        run = {"statuses": fe.status_counts(),
               "recoveries": fe.n_recoveries,
               "fault_log": [e for _, e in fe.fault_log],
               "fault_kinds": _fault_kinds(fe),
               "injector_log": list(inj.log) if inj else [],
               "tokens": {t.rid: list(t.tokens)
                          for t in fe.tickets.values()},
               "ticket_recoveries": sorted(t.n_recoveries
                                           for t in fe.tickets.values()),
               "launches": counts, "committed_launches": pred,
               "ragged_dispatches": est.ragged_dispatches,
               "decode_steps": decode_steps, "wall_ms": wall * 1e3,
               "captures_warm": warm,
               "captures_after": _graph_captures(fe.engine)}
        if inj is not None:
            (nan_at,) = FE_FAULTS["nan_steps"]
            (crash_at,) = FE_FAULTS["crash_steps"]
            run["crash_dispatch_launches"] = probe.per_dispatch(crash_at,
                                                                counts)
            run["poisoned_dispatch_launches"] = probe.per_dispatch(nan_at,
                                                                   counts)
            # what each live request had committed when the first fault hit
            run["emitted_at_first_fault"] = probe.emitted[
                min(crash_at, nan_at)]
        runs[name] = run
        del fe
        _free(torch)
    return trace, plain, runs


def _frontend_tenants(torch, cfg, adapter_toks):
    """(a), tenants: phase adapters' requests through a paged frontend
    (pages of 16) with one crash, against the same engine unfaulted and
    against phase adapters' tokens; counts reset just before the faulty
    run and read just after."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.runtime import FaultInjector
    from repro_torch.serving import ServingFrontend
    lm, params, _ = serve.build_model(cfg, "cuda")
    store, tenants = serve.build_store(params, ADAPTER_TENANTS)
    cycle = [*tenants, None]
    n = adapter_toks.shape[0]
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(n, 128)).astype(np.int32)
    inj = FaultInjector(**FE_TENANT_FAULTS)
    fe = ServingFrontend(lm, store.base, n_slots=RAGGED_SLOTS,
                         max_len=128 + SERVE_GEN, prefill_chunk=RAGGED_CHUNK,
                         decode_burst=8, page_size=PAGE_SIZE, adapters=store,
                         queue_cap=n, injector=inj)
    warm = _warm(torch, fe)
    eng = fe.engine

    def unfaulted():
        rids = [eng.submit(p, SERVE_GEN, adapter_id=cycle[i % len(cycle)],
                           rid=i) for i, p in enumerate(prompts)]
        out = eng.run()
        return np.asarray([out[r] for r in rids], np.int32)
    clean = _detached(eng, unfaulted)
    eng.reset()
    kernels.reset_launches()
    tickets = [fe.submit(p, SERVE_GEN, adapter_id=cycle[i % len(cycle)],
                         rid=i) for i, p in enumerate(prompts)]
    fe.run_until_drained()
    torch.cuda.synchronize()
    counts = kernels.launches()
    est = fe.engine_stats
    pt = eng.page_table
    pt.check_invariants()
    out = {"statuses": fe.status_counts(), "recoveries": fe.n_recoveries,
           "fault_kinds": _fault_kinds(fe), "injector_log": list(inj.log),
           "tokens": [list(t.tokens) for t in tickets],
           "unfaulted": clean.tolist(), "launches": counts,
           "ragged_dispatches": est.ragged_dispatches,
           "decode_steps": est.model_steps
           - RAGGED_CHUNK * est.ragged_dispatches,
           "pool_drained": pt.n_used == 0,
           "captures_warm": warm, "captures_after": _graph_captures(eng)}
    del fe, eng, store, lm, params
    _free(torch)
    return out


def _timed(fe):
    """Wrap the frontend's ``step`` and its engine's ``step_once`` (on the
    instances, for this run) to sum the wall of the frontend iterations
    that stepped the engine and of those engine steps: their difference is
    the frontend's own host cost."""
    rec = {"frontend_s": 0.0, "engine_s": 0.0, "engine_steps": 0,
           "stepped": False}
    step, once = fe.step, fe.engine.step_once

    def engine_step():
        t0 = time.perf_counter()
        rec["stepped"] = True
        try:
            once()
        finally:
            rec["engine_s"] += time.perf_counter() - t0
            rec["engine_steps"] += 1

    def frontend_step():
        rec["stepped"] = False
        t0 = time.perf_counter()
        busy = step()
        if rec["stepped"]:
            rec["frontend_s"] += time.perf_counter() - t0
        return busy
    fe.step, fe.engine.step_once = frontend_step, engine_step
    return rec


def _busy_ms(prof):
    """Device busy ms of a profiled window: the union of the intervals of
    every device activity (kernels, copies, sets)."""
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type().name == "CUDA")
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6, len(spans)


def _slo_run(torch, lm, merged, trace, arrivals, *, max_len, deadline,
             injector=None, profiled=False):
    """One live run: a warmed frontend's serve thread, the trace replayed
    open-loop at ``arrivals`` from this thread, then ``stop()``; counts
    reset just before ``start()`` and read after the join."""
    from contextlib import nullcontext
    from repro_torch import kernels
    from repro_torch.serving import ServingFrontend, replay, slo_summary
    fe = ServingFrontend(lm, merged, queue_cap=SLO_QUEUE_CAP,
                         default_deadline_s=deadline, injector=injector,
                         max_len=max_len, **FE_ENGINE)
    warm = _warm(torch, fe)
    rec = _timed(fe)
    ctx = nullcontext()
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    kernels.reset_launches()
    with ctx as prof:
        t0 = time.perf_counter()
        fe.start()
        thread = fe._thread
        due0 = time.monotonic()
        replay(lambda r: fe.submit(r.prompt, r.max_new_tokens,
                                   eos_id=r.eos_id, rid=r.rid),
               trace, arrivals)
        fe.stop(timeout=JOIN_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launches()
    s = slo_summary(fe)
    late = [fe.tickets[r.rid].t_submit - (due0 + at)
            for r, at in zip(trace, arrivals)]
    out = {"slo": s, "statuses": fe.status_counts(),
           "thread_ended": not thread.is_alive(),
           "fault_kinds": _fault_kinds(fe),
           "injector_log": list(injector.log) if injector else [],
           "crashes": sum(k == "crash" for _, k in injector.log)
           if injector else 0,
           "tokens": {t.rid: (t.status.name, list(t.tokens))
                      for t in fe.tickets.values()},
           "launches": counts, "wall_ms": wall * 1e3,
           "generator_late_ms_max": max(late) * 1e3,
           "frontend_host_ms_per_dispatch":
               (rec["frontend_s"] - rec["engine_s"]) * 1e3
               / max(rec["engine_steps"], 1),
           "engine_ms_per_dispatch": rec["engine_s"] * 1e3
           / max(rec["engine_steps"], 1),
           "engine_steps": rec["engine_steps"],
           "captures_warm": warm,
           "captures_after": _graph_captures(fe.engine)}
    if prof is not None:
        busy, n_events = _busy_ms(prof)
        out.update(device_busy_ms=busy, device_events=n_events,
                   device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)))
    del fe, prof
    _free(torch)
    return out


def _slo_calibrate(torch, cfg, lm, merged, max_len):
    """The SLO runs' calibration: a saturated run, 2 x slots requests
    submitted at once to a started (warmed) frontend.  Returns (its
    record, the offered rate, 0.7 x its finished requests a second, and
    the total deadline, 3 x its slowest latency)."""
    from repro_torch.serving import ServingFrontend, make_trace, slo_summary
    cal = ServingFrontend(lm, merged, queue_cap=SLO_REQUESTS,
                          max_len=max_len, **FE_ENGINE)
    cal_warm = _warm(torch, cal)
    cal.start()
    cal_thread = cal._thread
    for r in make_trace(2 * RAGGED_SLOTS, cfg.vocab,
                        **dict(SLO_TRACE, seed=7)):
        cal.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id)
    cal.stop(timeout=JOIN_S)
    torch.cuda.synchronize()
    cap = slo_summary(cal)
    lat = [t.t_done - t.t_submit for t in cal.tickets.values()
           if t.t_done is not None]
    rate = SLO_LOAD * cap["finished"] / max(cal.wall_s, 1e-9)
    deadline = max(3.0 * max(lat), 0.1)
    calibration = {"slo": cap, "wall_ms": cal.wall_s * 1e3,
                   "slowest_latency_ms": max(lat) * 1e3, "rate_req_s": rate,
                   "deadline_ms": deadline * 1e3,
                   "thread_ended": not cal_thread.is_alive(),
                   "captures_warm": cal_warm,
                   "captures_after": _graph_captures(cal.engine)}
    del cal
    _free(torch)
    return calibration, rate, deadline


def _frontend_slo(torch, cfg, lm, merged):
    """(b): calibration, then Poisson and bursty arrivals, each clean and
    faulty, then one clean Poisson run under ``torch.profiler`` for the
    device's idle share."""
    from repro_torch.runtime import FaultInjector
    from repro_torch.serving import (bursty_arrivals, make_trace,
                                     poisson_arrivals)
    trace = make_trace(SLO_REQUESTS, cfg.vocab, **SLO_TRACE)
    max_len = max(SLO_TRACE["prompt_lens"]) + max(SLO_TRACE["gen_lens"])
    plain = _engine_streams(lm, merged, trace, max_len=max_len, **FE_ENGINE)
    _free(torch)
    calibration, rate, deadline = _slo_calibrate(torch, cfg, lm, merged,
                                                 max_len)
    arrivals = {"poisson": poisson_arrivals(SLO_REQUESTS, rate, seed=1),

                "bursty": bursty_arrivals(SLO_REQUESTS, rate,
                                          burst=SLO_BURST, seed=1)}
    runs = {}
    for arr, at in arrivals.items():
        for mode in ("clean", "faulty"):
            inj = FaultInjector(**SLO_FAULTS) if mode == "faulty" else None
            runs[f"{arr}-{mode}"] = _slo_run(
                torch, lm, merged, trace, at, max_len=max_len,
                deadline=deadline, injector=inj)
            r = runs[f"{arr}-{mode}"]
            s = r["slo"]
            print(f"[chip_smoke] frontend SLO {arr}-{mode}: ttft p50/p95/p99 "
                  f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p95_s'] * 1e3:.1f}/"
                  f"{s['ttft_p99_s'] * 1e3:.1f} ms, tpot p50/p95/p99 "
                  f"{s['tpot_p50_s'] * 1e3:.2f}/{s['tpot_p95_s'] * 1e3:.2f}/"
                  f"{s['tpot_p99_s'] * 1e3:.2f} ms, timeout rate "
                  f"{s['timeout_rate']:.3f}, reject rate "
                  f"{s['reject_rate']:.3f}, goodput "
                  f"{s['goodput_tok_s']:.1f} tok/s, recoveries "
                  f"{s['recoveries']}, {s['finished']}/{s['n_requests']} "
                  f"finished; frontend host "
                  f"{r['frontend_host_ms_per_dispatch']:.3f} ms a dispatch",
                  flush=True)
    traced = _slo_run(torch, lm, merged, trace, arrivals["poisson"],
                      max_len=max_len, deadline=deadline, profiled=True)
    print(f"[chip_smoke] frontend: device idle share of a clean Poisson run "
          f"under torch.profiler {traced['device_idle_share']:.3f} "
          f"({traced['device_busy_ms']:.1f} ms busy of "
          f"{traced['wall_ms']:.1f})", flush=True)
    return trace, plain, calibration, runs, traced


def _prefix_ok(tokens, plain):
    """Every ticket's tokens a prefix of the plain engine's stream for its
    request, and every FINISHED ticket's the whole stream; no FAILED."""
    return all(status != "FAILED" and toks == plain[rid][:len(toks)]
               and (status != "FINISHED" or toks == plain[rid])
               for rid, (status, toks) in tokens.items())


def _recovery_checks(rec, plain, per_step, routed=False):
    """The gates of (a)'s recovery runs (:func:`_frontend_recovery`):
    every ticket FINISHED, exactly the two injected recoveries, the fault
    log naming them, nothing launched by the crashed dispatch, the
    poisoned dispatch run whole, kernels 1 and 2 ``per_step`` a committed
    model step plus the poisoned dispatch's own.  Tokens: a dense model's
    recovered streams are the clean run's and the plain engine's.  A
    capacity-routed MoE (``routed``) prefills a recovered request again in
    another batch, and a row's experts depend on its batch, so there the
    clean run must give the plain engine's streams and the faulty run the
    clean run's tokens up to what each request had committed when the
    first fault hit (the reference's recovery does the same:
    tests/test_torch_frontend.py)."""
    clean, faulty = rec["clean"], rec["faulty"]
    poisoned = faulty["poisoned_dispatch_launches"]
    in_ragged = any("ragged step" in e for e in faulty["fault_log"])
    # the poisoned dispatch ran whole (its graph replayed) before its
    # health bit tripped: one ragged step's kernel 1, or a burst's kernel 2
    poisoned_ok = (poisoned == {"qmatmul": per_step} if in_ragged else (
        set(poisoned) == {"qmatvec"}
        and poisoned["qmatvec"] // per_step in (1, 2, 4)
        and poisoned["qmatvec"] % per_step == 0))

    def predicted(run, extra=None):
        want = dict(run["committed_launches"])
        for k, v in (extra or {}).items():
            want[k] = want.get(k, 0) + v
        return all(run["launches"][k] == want.get(k, 0)
                   for k in run["launches"])
    checks = {
        "recovery_all_finished": all(
            r["statuses"] == {"FINISHED": FE_REQUESTS} for r in rec.values()),
        "recovery_exactly_two": faulty["recoveries"] == 2
        and clean["recoveries"] == 0
        and faulty["injector_log"] == [(3, "crash"), (7, "nan")],
        "recovery_fault_log_named": faulty["fault_kinds"]
        == ["EngineCorrupted", "InjectedFault"],
        "recovery_crash_launched_nothing":
            faulty["crash_dispatch_launches"] == {},
        "recovery_poisoned_dispatch_ran_whole": poisoned_ok,
        "recovery_launches_as_predicted": predicted(clean)
        and predicted(faulty, poisoned)}
    if routed:
        before = faulty["emitted_at_first_fault"]
        checks["recovery_clean_equals_plain"] = clean["tokens"] == plain
        checks["recovery_tokens_before_first_fault_equal_clean"] = bool(
            before) and all(
                faulty["tokens"][rid][:n] == clean["tokens"][rid][:n]
                for rid, n in before.items())
    else:
        checks["recovery_tokens_equal_clean_and_plain"] = \
            faulty["tokens"] == clean["tokens"] == plain
    return checks


def phase_frontend(torch, adapter_toks):
    """The fault-tolerant frontend at full width and depth: (a) recovery,
    synchronous, on the merged model and on phase adapters' tenants; (b)
    four live SLO runs on the serve thread, and a fifth under the
    profiler."""
    import repro_torch.configs as C
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    cfg = C.get("llama7b-proxy")
    lm, _, merged = serve.build_model(cfg, "cuda")
    trace, plain, rec = _frontend_recovery(torch, cfg, lm, merged)
    slo_trace, slo_plain, calibration, slo, traced = _frontend_slo(
        torch, cfg, lm, merged)
    del lm, merged
    _free(torch)
    tenants = _frontend_tenants(torch, cfg, adapter_toks)
    per_step = _step_linears(cfg)
    faults_named = (set(rec["faulty"]["fault_kinds"])
                    <= {"InjectedFault", "EngineCorrupted"}
                    and set(tenants["fault_kinds"]) <= {"InjectedFault"}
                    and all(set(r["fault_kinds"]) <= {"InjectedFault"}
                            for r in slo.values()))
    checks = _recovery_checks(rec, plain, per_step)
    checks.update({
        "recovery_fault_log_named": checks["recovery_fault_log_named"]
        and faults_named,
        "recovery_no_capture_after_first_pass": all(
            r["captures_after"] == r["captures_warm"]
            for r in (*rec.values(), tenants, calibration, *slo.values(),
                      traced)),
        "tenants_all_finished": tenants["statuses"] == {
            "FINISHED": adapter_toks.shape[0]},
        "tenants_tokens_equal_unfaulted":
            tenants["tokens"] == tenants["unfaulted"],
        "tenants_tokens_equal_phase_adapters":
            tenants["tokens"] == adapter_toks.tolist(),
        "tenants_one_recovery": tenants["recoveries"] == 1
        and tenants["injector_log"] == [(5, "crash")],
        "tenants_launches_as_predicted": all(
            tenants["launches"][k] == {
                "qmatmul": per_step * tenants["ragged_dispatches"],
                "qalora_slot_matvec": per_step * tenants["decode_steps"],
                "qalora_slot_rank_proj": per_step * tenants["decode_steps"],
            }.get(k, 0) for k in tenants["launches"]),
        "tenants_pool_drained": tenants["pool_drained"],
        "slo_threads_ended": calibration["thread_ended"] and all(
            r["thread_ended"] for r in (*slo.values(), traced)),
        "slo_no_failed_ticket": all(
            "FAILED" not in r["statuses"] for r in (*slo.values(), traced)),
        "slo_recoveries_equal_crashes": all(
            r["slo"]["recoveries"] == r["crashes"]
            for r in (*slo.values(), traced)),
        "slo_faulty_runs_crashed": all(
            r["crashes"] >= 1 for k, r in slo.items() if "faulty" in k),
        "slo_tokens_prefix_of_plain": all(
            _prefix_ok(r["tokens"], slo_plain)
            for r in (*slo.values(), traced)),
        "slo_some_finished": all(r["slo"]["finished"] > 0
                                 for r in slo.values()),
        "slo_only_path_kernels": all(
            v == 0 for r in slo.values() for k, v in r["launches"].items()
            if k not in PTQ_PATH),
        "fault_logs_named": faults_named,
    })
    for r in rec.values():
        r["tokens"] = {str(k): v for k, v in r["tokens"].items()}
    for r in (*slo.values(), traced):
        r["tokens"] = {str(k): v for k, v in r["tokens"].items()}
    tenants["tokens"] = [t[:8] for t in tenants["tokens"]]
    tenants["unfaulted"] = [t[:8] for t in tenants["unfaulted"]]
    out = {"phase": "frontend", "arch": cfg.name, "n_layers": cfg.n_layers,
           "engine": dict(FE_ENGINE), "recovery": rec,
           "recovery_trace": dict(FE_TRACE, requests=FE_REQUESTS),
           "tenants": tenants, "slo_trace": dict(
               SLO_TRACE, requests=SLO_REQUESTS, queue_cap=SLO_QUEUE_CAP,
               load=SLO_LOAD, burst=SLO_BURST, faults=SLO_FAULTS),
           "calibration": calibration, "slo": slo, "traced": traced,
           "launches_per_step": per_step,
           "phase_s": time.perf_counter() - t_phase,
           "tokens_note": "random weights: streams fall into two-token "
                          "cycles, so the prefix gate and the tenants' "
                          "run are what make the token gates bite",
           "depth_cut": "none (all 32 layers)", "checks": checks}
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"frontend checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {"frontend recovery, clean and faulted (phase frontend)":
            _sum_counts(r["launches"] for r in rec.values()),
            "frontend tenants' recovery (phase frontend)":
            tenants["launches"],
            "frontend SLO runs (phase frontend)":
            _sum_counts(r["launches"] for r in slo.values())}


def _sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


# ---------------------------------------------------------------------------
# phases 11-12: QA-LoRA fine-tuning
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


# a (token, layer) whose own top-2 differs from the card's must be a near
# tie: the top-2 probability the card's choice gives up in this side's
# eyes stays under this.  bf16 moves a full-width router logit by a few
# 1e-2 (8-bit significands over d = 6144 products a block), which gives
# up ~1e-2 of probability at a tie (1.6e-2 read card vs CPU at 2 layers,
# H100 80GB HBM3, 700 W).  Planted at layer 0 of that run
# (:func:`_planted_misrouting`): a token sent to its two least probable
# experts gives up 0.84, the least misrouting (second choice for third)
# a median 0.046, which the limit sees at half the tokens
MOE_TIE_GAP = 5e-2
# the share of (token, layer) routings in which the f32 CPU was to be
# allowed to choose otherwise than the bf16 card (a reading)
MOE_FLIP_LIMIT = 0.01


@contextlib.contextmanager
def _routed_as(torch, params, card_route, own):
    """Every MoE layer of ``params`` routes its tokens to the experts the
    card chose there (``card_route``, one ``record_routing`` entry a
    layer) through ``moe.choose_experts``; each layer's own top-k choice
    (the first call's: a remat recompute repeats it) goes into ``own``
    [layer] as (own ids, the card's ids, this side's probabilities)."""
    from repro_torch.models import moe
    layer_of = {id(blk["moe"]): i for i, blk in enumerate(params.blocks)}

    def choose(p, idx, probs):
        layer = layer_of[id(p)]
        card = card_route[layer]["idx"].reshape(idx.shape).to(idx.device)
        own.setdefault(layer, (idx, card, probs))
        return card
    with moe.choose_experts(choose):
        yield own


def _own_choice(torch, own):
    """Per layer, the share of tokens whose own top-k set differs from the
    card's, and the largest top-k probability the card's choice gives up
    in this side's eyes (0 where they agree)."""
    out = []
    for layer in sorted(own):
        mine, card, probs = own[layer]
        differ = ~(mine.sort(-1)[0] == card.sort(-1)[0]).all(-1)
        gap = probs.gather(-1, mine).sum(-1) - probs.gather(-1, card).sum(-1)
        out.append({"differ_share": float(differ.float().mean()),
                    "differ": int(differ.sum()),
                    "max_gap_given_up": float(gap.max())})
    return out


def _planted_misrouting(torch, own0, every=16):
    """``MOE_TIE_GAP`` against routings it must reject, at layer 0 (whose
    router input no routing upstream moves; ``own0``: that layer's
    :func:`_routed_as` entry): every ``every``-th token sent to its two
    least probable experts, the largest top-k probability given up (the
    limit must see it); and each token's second choice swapped for its
    third (the least misrouting there is): the median probability that
    gives up and the share of tokens where the limit would see it."""
    mine, _, probs = own0
    k = mine.shape[1]
    order = probs.argsort(dim=-1, descending=True)
    planted = mine.clone()
    planted[::every] = order[::every, -k:]
    given_up = probs.gather(-1, mine).sum(-1) - probs.gather(-1, planted) \
        .sum(-1)
    ranked = probs.gather(-1, order[:, :k + 1])
    swap = ranked[:, k - 1] - ranked[:, k]
    return {"misrouted_every": every,
            "misrouted_max_gap": float(given_up.max()),
            "second_for_third_gap_median": float(swap.median()),
            "second_for_third_seen_share":
                float((swap > MOE_TIE_GAP).float().mean())}


def phase_train_small(torch, device="cuda", n_layers=2, seq=128, batch=2,
                      mode="qalora", arch="llama7b-proxy",
                      phase="train_small"):
    """One train step of ``arch`` at full width and ``n_layers``
    layers (bf16, remat as the config says; the adapters are a seeded demo
    tenant's, so B is nonzero and every gradient is too, where an
    initialised B = 0 gives A none) on the card through the
    kernels, against the same step on the CPU through the plain versions,
    on the same weights upcast to f32 and one batch of ``batch`` x ``seq``
    tokens from the port's stream.  Gradients are read back from the
    first moments (mu = (1 - b1) * clipped g).  ``mode`` lora or qlora
    trains that baseline's adapters (plain products, no port kernel).

    A gqa_moe model records the card's routing (``moe.record_routing``,
    once a layer: the remat recompute records nothing), and the CPU step
    routes every token to the experts the card chose (:func:`_routed_as`):
    bf16 moves a near-tie token's top-2 where f32 does not, a flip
    changes what the token trains, and through capacity and attention
    the flips of one layer spread to the next, so with free routing
    neither the gradients nor the loss would compare.  Each CPU layer's
    own choice is recorded beside the card's: where they differ it must
    be a near tie (``MOE_TIE_GAP``), and a planted misrouting must not
    be (:func:`_planted_misrouting`).  The share that differs is a
    reading beside ``MOE_FLIP_LIMIT``, the share a comparison with free
    routing on both sides was meant to allow (exceeded: 2.9 %)."""
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.data import make_stream
    from repro_torch.launch.serve import demo_tenant
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.models.lm import LM
    from repro_torch.models.moe import record_routing
    from repro_torch.optim import AdamWConfig, adamw_init, trainable_tensors
    cfg = C.get(arch)
    cfg = cfg.scaled(n_layers=n_layers, quant=dataclasses.replace(
        cfg.quant, mode=mode))
    moe = cfg.family == "gqa_moe"
    lm = LM(cfg)
    card = demo_tenant(lm.init(torch.Generator(device=device).manual_seed(0),
                               device), 1)
    cpu = copy.deepcopy(card).to("cpu").float()
    toks, labs = make_stream("alpaca", vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch).next_batch()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, max_grad_norm=0.3)
    # the CPU recomputes nothing: a remat recompute repeats the same f32
    # forward, so its gradients are the same, and it would cost a third
    # more of the CPU step (~58 s for 2-layer mixtral)
    steps = {"card": make_train_fn(lm, opt_cfg),
             "cpu": make_train_fn(LM(cfg.scaled(remat=False)), opt_cfg)}
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
    sides, own = {}, {}
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
        with (record_routing() if moe else contextlib.nullcontext([])) \
                as route, (_routed_as(torch, params, sides["card"]["route"],
                                      own)
                           if moe and side == "cpu"
                           else contextlib.nullcontext()):
            m = steps[side](params, opt, batch_t)
            loss = float(m["loss"])
        secs = time.perf_counter() - t0
        gnorm = float(m["grad_norm"])
        clip = min(1.0, opt_cfg.max_grad_norm / max(gnorm, 1e-9))
        sides[side] = {
            "loss": loss, "xent": float(m["xent"]), "aux": float(m["aux"]),
            "grad_norm": gnorm, "seconds": secs,
            "launches": kernels.launches(), "tr": tr, "before": before,
            "opt": opt, "route": [{k: v.cpu() for k, v in r.items()}
                                  for r in route],
            "grad": {k: opt["mu"][k] / (1 - opt_cfg.b1) / clip for k in tr}}
    c, p = sides["card"], sides["cpu"]
    routing = None
    if moe:
        by_layer = _own_choice(torch, own)
        routing = {
            "layers_recorded": [len(c["route"]), len(p["route"])],
            "cpu_routed_as_card": all(
                torch.equal(a["idx"], b["idx"]) and torch.equal(a["keep"],
                                                                b["keep"])
                for a, b in zip(c["route"], p["route"])),
            "cpu_own_choice_by_layer": by_layer,
            "cpu_own_choice_differs": sum(r["differ"] for r in by_layer)
            / (len(by_layer) * batch * seq),
            "tie_gap_limit": MOE_TIE_GAP,
            "tie_gap_planted": _planted_misrouting(torch, own[0]),
            "flip_limit_free_routing": MOE_FLIP_LIMIT,
            "dropped_share": float(sum((~r["keep"]).sum() for r in c["route"])
                                   / sum(r["keep"].numel()
                                         for r in c["route"]))}
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
    per_step = _step_linears(cfg) * (2 if cfg.remat else 1) \
        if mode == "qalora" else 0
    loss_rel = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    launches = c["launches"]
    out = {"phase": phase, "mode": mode,
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
           "xent": {"card": c["xent"], "cpu": p["xent"],
                    "rel": abs(c["xent"] - p["xent"]) / abs(p["xent"])},
           "aux": {"card": c["aux"], "cpu": p["aux"],
                   "rel": abs(c["aux"] - p["aux"]) / max(abs(p["aux"]),
                                                         1e-30)},
           "routing": routing,
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
        "xent_within_bound": out["xent"]["rel"] <= TRAIN_LOSS_TOL,
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
    if moe:
        checks.update({
            "aux_within_bound": out["aux"]["rel"] <= TRAIN_LOSS_TOL,
            "routing_recorded_once_a_layer": routing["layers_recorded"]
            == [n_layers, n_layers],
            "cpu_routed_as_card": routing["cpu_routed_as_card"],
            "cpu_own_choice_differs_only_at_near_ties": all(
                r["max_gap_given_up"] <= MOE_TIE_GAP
                for r in routing["cpu_own_choice_by_layer"]),
            "tie_gap_limit_rejects_misrouted_tokens":
                routing["tie_gap_planted"]["misrouted_max_gap"]
                > MOE_TIE_GAP})
    out.update(checks=checks, ok=all(checks.values()))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{phase} checks failed: {checks}")


def _train_linears(cfg, blk, m):
    """Block ``blk``'s ``qalora`` linears with the rows a train step of
    ``m`` tokens gives each and how many such linears a layer has:
    attention and the dense MLP at M = m, once; an MoE's expert 0 gate, up
    and down at its capacity C (one routing group of m tokens), for each
    of the E experts."""
    lps = [(f"attn/{n}", blk["attn"][n], m, 1)
           for n in ("wq", "wk", "wv", "wo")]
    if "moe" in blk:
        c = _moe_capacity(cfg, m)
        return lps + [(f"moe/{n}/0", getattr(blk["moe"], n)[0], c,
                       cfg.n_experts) for n in ("gate", "up", "down")]
    return lps + [(f"mlp/{n}", blk["mlp"][n], m, 1)
                  for n in ("gate", "up", "down") if n in blk["mlp"]]


def _train_linears_at_m(torch, cfg, params, m):
    """One layer's ``qalora`` linears of the trained model at the rows a
    train step of ``m`` tokens gives them (:func:`_train_linears`), each
    held against its plain version, then timed, ms per layer (an expert
    linear's times counted once for each expert).  Checks,
    each within two bf16 steps of the plain version's max (the tolerance
    of phase kernels): kernel 3 with 3a (``ops.qalora_matmul``, the path's
    call) on the trained adapters; kernel 3 again with a seeded B of rms
    0.01 in place of the trained one, whose adapter term (B moved by
    ~4 lr from 0 in four steps) is far under that tolerance, so that the
    epilogue's ``s t B`` is seen at this M too; and 3a alone on the
    trained A.  Times: kernel 3's forward (with 3a), the plain backward of
    ``_QALoRAMatmul`` (dx, dA, dB) alone, its ``dY dequant(W)^T`` product
    alone, and cuBLAS's ``x @ W`` on the pre-dequantised bf16 weight; ms
    per layer, CUDA events; and under ``per_linear`` each linear's kernel
    3, plain version and cuBLAS times beside its bound.  Runs after the
    path's counting window.  Returns (times, check rows)."""
    from repro_torch.core import schemes
    from repro_torch.kernels import ops
    from repro_torch.kernels.qalora_fused import (
        qalora_matmul_cuda, qalora_matmul_plain, qalora_rank_proj_cuda,
        qalora_rank_proj_plain)
    from repro_torch.kernels.qmatmul import dequant_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = {"kernel3_fwd_ms": 0.0, "plain_bwd_ms": 0.0, "bwd_dx_product_ms": 0.0,
           "cublas_fwd_ms": 0.0}
    rows, per_linear = [], []

    def held(name, got, ref, **what):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        tol = 2.0 ** -6 * ref.abs().max().item()
        finite = bool(torch.isfinite(got).all())
        rows.append({"kernel": name, "M": m_lin, "linear": where, **what,
                     "max_abs_err": err, "tol": tol, "finite": finite,
                     "ok": finite and err <= tol})
    for where, lp, m_lin, times in _train_linears(cfg, params.blocks[0], m):
        qt, ad = schemes.quantized_base(lp), schemes.adapter_params(lp)
        x = torch.randn((m_lin, qt.d_in), generator=gen, device="cuda") \
            .to(torch.bfloat16).requires_grad_(True)
        dy = torch.randn((m_lin, qt.d_out), generator=gen, device="cuda") \
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
            k3 = _time_ms(torch, lambda: ops.qalora_matmul(x, qt, ad, s),
                          [()], 5)
            plain = _time_ms(torch, lambda: qalora_matmul_plain(
                xd, *q, ad.a, ad.b, **kw), [()], 2)
            tot["kernel3_fwd_ms"] += times * k3
        y = ops.qalora_matmul(x, qt, ad, s)
        tot["plain_bwd_ms"] += times * _time_ms(
            torch, lambda: torch.autograd.grad(y, (x, ad.a, ad.b), dy,
                                               retain_graph=True), [()], 3)
        w32 = dequant_plain(qt.qweight, qt.scale, qt.zero, qt.bits,
                            qt.group_size, torch.bfloat16).float()
        dyf = dy.float()
        tot["bwd_dx_product_ms"] += times * _time_ms(
            torch, lambda: dyf @ w32.T, [()], 3)
        w16 = w32.to(torch.bfloat16)
        cublas = _time_ms(torch, lambda: xd @ w16, [()], 5)
        tot["cublas_fwd_ms"] += times * cublas
        per_linear.append({
            "linear": where, "M": m_lin, **shape, "per_layer": times,
            "kernel3_fwd_ms": k3, "plain_ms": plain, "cublas_fwd_ms": cublas,
            **_bound(m_lin, qt.d_in, qt.d_out, qt.bits, n_adapters=1)})
        del y, w32, w16, dyf
    torch.cuda.empty_cache()
    tot["per_linear"] = per_linear
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
                resume_at=TRAIN_RESUME_AT, prompt_len=128, phase="train",
                hold_kernels=True):
    """``repro_torch.launch.train`` on the full llama7b-proxy (or the model
    ``argv`` names) through its own ``setup`` and ``run``: ``steps``
    steps with a checkpoint every ``resume_at``, counts reset just before
    the loop and read just after; the frozen base bit-identical before and
    after; B nonzero after step 1; the merge of the trained adapters and
    ``serve.merge_check`` on it (a gqa_moe model: a reading, and the same
    merge in f32 on the CPU within ``MERGE_F32_GAP`` of the adapter term,
    :func:`_merge_cpu_f32`); with ``hold_kernels``, kernels 3 and 3a held
    at the step's shapes; then
    a second run resumed from the step-``resume_at`` checkpoint (hard-link
    copies in a directory of its own), whose losses and adapters must equal
    the uninterrupted run's bit for bit (the same kernels and cuBLAS calls
    at the same shapes, in the same order, on the same values)."""
    import shutil
    import numpy as np
    import repro_torch.configs as C
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
        per_layer = _step_linears(st.cfg) // st.cfg.n_layers
        per_step = _step_linears(st.cfg) * (
            2 if st.cfg.remat else 1)
        step_launches = res["launches"]
        # the merged model against the trained adapter model
        prompts = np.random.default_rng(0).integers(
            4, st.cfg.vocab, size=(4, prompt_len)).astype(np.int32)
        kernels.reset_launches()
        merged = serve.merge_model(st.params)
        mcheck = serve.merge_check(st.lm, st.params, merged, prompts,
                                   prompt_len + 1, device=dev)
        merge_counts = kernels.launches()
        bound = serve.merge_bound(st.cfg)
        moe = st.cfg.family == "gqa_moe"
        if moe:
            mcheck["routing_by_layer"] = _merge_routing(
                torch, st.lm, st.params, merged, prompts)
            if dev.type == "cuda":
                mcheck["precision"] = _merge_precision(torch, st.params,
                                                       merged)
        del merged
        f32 = (_merge_cpu_f32(torch, st.lm, st.params, prompts[:1])
               if moe else None)
        trained = {k: v.detach().clone() for k, v in st.trainable.items()}
        m_train = args.global_batch * args.seq_len
        timing, at_m = (_train_linears_at_m(torch, st.cfg, st.params,
                                            m_train)
                        if dev.type == "cuda" and hold_kernels
                        else ({}, []))
        full_layers = C.get(st.cfg.name).n_layers
        del st, res["state"], inner, step_fn
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
    remat = per_step // (per_layer * layers)
    out = {"phase": phase,
           "card": _smi("name,power.limit") if dev.type == "cuda" else "cpu",
           "arch": res["arch"], "n_layers": layers,
           "depth_cut": (f"none (all {layers} layers)"
                         if layers == full_layers
                         else f"{layers} of {full_layers} layers"),
           "batch": [args.global_batch, args.seq_len], "dataset": args.dataset,
           "lr": args.lr, "steps": steps, "setup_s": setup_s,
           "loss": res["loss"], "xent": res["xent"], "aux": res["aux"],
           "grad_norm": res["grad_norm"],
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
           "merge_cpu_f32": f32, "merge_launches": merge_counts}
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
    }
    checks["merge_path_kernels_launched"] = all(
        merge_counts[k] > 0 for k in MERGE_PATH)
    if f32 is None:
        checks["merge_within_bound"] = all(r["rel"] <= bound
                                           for r in mcheck.values())
    else:
        # bf16 breaks a near tie of the random router otherwise in the
        # merged model than in the adapter model (the card's merge check
        # above, a reading); in f32 the merge is the adapter model's
        # function up to rounding, and the adapters dropped are not
        checks.update({
            "merge_f32_routed_alike": _routed_alike(f32["merged"]),
            # the adapters dropped (the untrained ones: B = 0) read 1
            "merge_f32_within_gap_of_adapter_term":
                f32["merged_over_dropped"] <= MERGE_F32_GAP})
    if hold_kernels and dev.type == "cuda":
        # kernel 3 and 3a against their plain versions at the step's M
        checks["kernel3_and_3a_at_train_M_within_bound"] = (
            {r["kernel"] for r in at_m} == set(TRAIN_PATH)
            and all(r["ok"] for r in at_m))
    out.update(checks=checks, ok=all(checks.values()))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{phase} checks failed: {checks}")
    errs = {k: max(r["max_abs_err"] for r in at_m if r["kernel"] == k)
            for k in TRAIN_PATH} if at_m else {}
    return counts, errs


# ---------------------------------------------------------------------------
# phase 13: the paper's quantizers and baselines
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


def _hold_intq_linears(torch, blk, gen, tiled_m=TILED_M):
    """Kernels 1 (M = ``tiled_m``) and 2 (M = 4) on one layer's ``intq``
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
        for kern, plain, m in ((qmatmul_cuda, qmatmul_plain, tiled_m),
                               (qmatvec_cuda, qmatvec_plain, GEMV_M)):
            x = torch.randn((m, qt.d_in), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            y, ref = kern(x, *args, **kw).float(), plain(x, *args, **kw).float()
            err = (y - ref).abs().max().item()
            tol = 2.0 ** -6 * ref.abs().max().item()
            rows.append({"kernel": kern.__name__.replace("_cuda", ""),
                         "linear": f"{grp}/{name}", "bits": qt.bits,
                         "M": m, "K": qt.d_in,
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
    n_lin = _step_linears(cfg)
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


# ---------------------------------------------------------------------------
# phase 14: the other dense gqa configs and mixtral (gqa_moe) at full width
# ---------------------------------------------------------------------------

# (arch, layers served: None = the config's own depth).  Widths are the
# published ones; deepseek-67b (0.43 GB a layer at int4 g32) and
# mixtral-8x22b (1.57 GB a layer: 4 + 24 expert linears) are cut in depth
# so the adapter model and its merge fit the card's 80 GB beside each
# other
# mixtral at 8 of 56 layers: phases moe_train and moe_serve run it at 16
FAMILY_CUTS = (("h2o-danube-1.8b", None), ("starcoder2-7b", None),
               ("deepseek-67b", 16), ("mixtral-8x22b", 8))
# the continuous engine (contiguous and paged, graphed and eager) runs on
# these: the dense config with head_dim 80, and the MoE
FAMILY_ENGINES = ("h2o-danube-1.8b", "mixtral-8x22b")
FAMILY_TRACE = dict(seed=3, prompt_lens=(64, 96, 128), gen_lens=(16, 32, 24))
FAMILY_REQUESTS = 8
FAMILY_TIMED = 3  # static passes after the capturing one; medians
# an MoE merge check (and phase small's card-vs-CPU check) needs at least
# this share of its tokens routed alike at every layer, and at most this
# share of its (token, layer) routings flipped: sound runs read 0.990 and
# 0.061 % (mixtral prefill), 1.0 and 0 (its decode step, phase small)
FAMILY_AGREE_MIN, FAMILY_FLIP_MAX = 0.95, 0.01
# the negative control: the merge check with the merged experts' outputs
# times (1 + f x normal noise), seeded, for each f; the rule must reject
# every f from FAMILY_FAULT_REJECT up
FAMILY_FAULTS = (2.0 ** -8, 2.0 ** -6, 2.0 ** -4, 2.0 ** -2)
FAMILY_FAULT_REJECT = 2.0 ** -4


def _linear_bytes(params):
    """Bytes of every linear's stored tensors (codes, scales, zeros,
    adapters, fp weights): what a decode step must read once."""
    from repro_torch.core import schemes
    return sum(b.numel() * b.element_size() for m in params.modules()
               if schemes.is_linear(m) for b in m.buffers())


def _prefill_flops(cfg, b, s):
    """Operations of a prefill of b x s tokens: every linear at the rows it
    computes (an MoE's experts at their capacity buffers), the attention
    scores and values over the causal half, the head on the last token."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * b * s * d * hd * 2 * (cfg.n_heads + cfg.n_kv_heads)
    scores = 2 * b * cfg.n_heads * s * min(s, cfg.window or s) * hd
    if cfg.family == "gqa_moe":
        chunk = cfg.moe_chunk if 0 < cfg.moe_chunk < s else s
        cap = _moe_capacity(cfg, b * chunk) * (s // chunk)
        ffn = 2 * cap * d * cfg.moe_d_ff * 3 * cfg.n_experts
        ffn += 2 * b * s * d * cfg.n_experts  # the router
    else:
        ffn = 2 * b * s * d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    return cfg.n_layers * (attn + scores + ffn) + 2 * b * d * cfg.vocab


def _routed_alike(r) -> bool:
    """An MoE comparison (``serve.compare_routed``) routed enough tokens
    alike to hold its logits over them."""
    return (r["agreeing_tokens"] >= FAMILY_AGREE_MIN * r["tokens"]
            and r["flip_share"] <= FAMILY_FLIP_MAX)


def _moe_merge_ok(check, bound) -> bool:
    """An MoE merge check (``serve.merge_check``) passes: each pass routed
    alike and within ``bound`` over the tokens routed alike."""
    return all(_routed_alike(r) and r["rel"] <= bound
               for r in check.values())


def _moe_merge_close(check, bound) -> bool:
    """The routed rule without its flip limit: each pass routes at least
    ``FAMILY_AGREE_MIN`` of its tokens alike at every layer and is within
    ``bound`` over them."""
    return all(r["agreeing_tokens"] >= FAMILY_AGREE_MIN * r["tokens"]
               and r["rel"] <= bound for r in check.values())


def _moe_capacity(cfg, tokens: int) -> int:
    """An MoE layer's expert capacity C for one routing group of
    ``tokens`` rows (``repro_torch.models.moe``)."""
    return max(math.ceil(cfg.top_k * tokens / cfg.n_experts
                         * cfg.capacity_factor), 1)


@contextlib.contextmanager
def _record_rows(lm):
    """The ``n_new`` [B] of every ``lm.step_ragged`` call made in the
    context, a copy each (eager runs: one entry a model step)."""
    rows, step = [], lm.step_ragged

    def counted(params, cache, tokens, n_new):
        rows.append(n_new.detach().to("cpu", copy=True))
        return step(params, cache, tokens, n_new)
    object.__setattr__(lm, "step_ragged", counted)  # LM is frozen
    try:
        yield rows
    finally:
        object.__delattr__(lm, "step_ragged")


def _drop_shares(torch, rec, rows, n_layers, n_experts):
    """Routing of an eager engine run, by kind of model step (ragged or
    decode): ``rec`` the ``record_routing`` entries (``n_layers`` a step),
    ``rows`` each step's ``n_new``.  A row at or past its slot's
    ``n_new`` (an idle slot's, or a chunk's tail) is padding, and takes
    capacity as in the reference.  Reports the share of routed (row, k)
    assignments that capacity dropped, a step over all rows and pooled
    over the real rows (what served requests lose); the padding rows'
    share of the kept assignments; per expert the real assignments routed
    to it and dropped there; and the share of real rows (a layer) routed
    to the same experts as another real row of the step."""
    if len(rec) != n_layers * len(rows):
        raise AssertionError(f"{len(rec)} routings for {len(rows)} steps of "
                             f"{n_layers} layers")
    kinds = {}
    for j, n_new in enumerate(rows):
        step = rec[j * n_layers:(j + 1) * n_layers]
        keep = torch.stack([r["keep"].cpu() for r in step])  # [L, B, S, k]
        idx = torch.stack([r["idx"].cpu() for r in step])
        real = (torch.arange(keep.shape[2])[None, :] < n_new[:, None])[
            None, :, :, None].expand_as(keep)
        k = kinds.setdefault("ragged" if keep.shape[2] > 1 else "decode", {
            "all": [], "real": 0, "real_dropped": 0, "kept": 0,
            "kept_padding": 0, "rows": 0, "rows_shared": 0,
            "routed": torch.zeros(n_experts, dtype=torch.int64),
            "dropped": torch.zeros(n_experts, dtype=torch.int64)})
        k["all"].append(float((~keep).float().mean()))
        k["real"] += int(real.sum())
        k["real_dropped"] += int((real & ~keep).sum())
        k["kept"] += int(keep.sum())
        k["kept_padding"] += int((keep & ~real).sum())
        k["routed"] += torch.bincount(idx[real], minlength=n_experts)
        k["dropped"] += torch.bincount(idx[real & ~keep],
                                       minlength=n_experts)
        pairs = idx.sort(dim=-1).values[real[..., 0]]  # [rows x layers, k]
        for lay in range(n_layers):
            sel = pairs.view(n_layers, -1, pairs.shape[-1])[lay]
            _, counts = torch.unique(sel, dim=0, return_counts=True)
            k["rows"] += int(sel.shape[0])
            k["rows_shared"] += int(counts[counts > 1].sum())
    return {kind: {
        "steps": len(k["all"]),
        "all_rows_mean": sum(k["all"]) / len(k["all"]),
        "all_rows_max": max(k["all"]),
        "real_assignments": k["real"], "real_dropped": k["real_dropped"],
        "real_rows": k["real_dropped"] / max(k["real"], 1),
        "padding_share_of_kept": k["kept_padding"] / max(k["kept"], 1),
        "real_rows_sharing_routing": k["rows_shared"] / max(k["rows"], 1),
        "routed_by_expert": k["routed"].tolist(),
        "dropped_by_expert": k["dropped"].tolist()}
        for kind, k in kinds.items()}


def _profile_prefill(torch, lm, merged, prompts):
    """One merged prefill of ``prompts`` under ``torch.profiler``: wall
    ms (host clock, ending in a sync), device busy ms and device ms by
    kind of kernel (the port's tiled kernel, PyTorch's matmuls, the
    rest)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _device_us, _kind
    toks = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.prefill(merged, {"tokens": toks})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind = {}
    for evt in prof.key_averages():
        if evt.device_type.name == "CUDA":
            kind = _kind(evt.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + _device_us(evt) / 1e3
    return {"wall_ms": wall, "device_busy_ms": sum(by_kind.values()),
            "device_ms_by_kind": by_kind}


def _hold_family_linears(torch, cfg, params, merged, prefill_rows: int,
                         engine: bool):
    """Kernels 1-4 on block 0 of one family config, at the rows the served
    path gives each linear, against their plain versions (two bf16 steps
    of the plain version's max, as :func:`_hold_intq_linears`): the merged
    block through kernel 1 at the prefill's rows (and a ragged step's,
    with ``engine``) and kernel 2 at a decode step's, the adapter block
    through kernels 3 and 4 (each after 3a) at the prefill's and the
    decode step's, as the merge check runs them.  Attention and a dense
    MLP see every row of the step; an MoE's experts (expert 0's gate, up
    and down) see their capacity buffer: for mixtral 160 rows at a 4 x
    128 prefill, 80 at a 4 x 64 ragged step, 2 at a 4-slot decode step."""
    from repro_torch.core import schemes
    from repro_torch.kernels.qalora_fused import (qalora_matmul_cuda,
                                                  qalora_matmul_plain)
    from repro_torch.kernels.qmatmul import qmatmul_cuda, qmatmul_plain
    from repro_torch.kernels.qmatvec import (qalora_matvec_cuda,
                                             qalora_matvec_plain,
                                             qmatvec_cuda, qmatvec_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    steps = {"prefill": prefill_rows, "decode": GEMV_M}
    if engine:
        steps["ragged"] = RAGGED_M
    names = [("attn", n, None) for n in ("wq", "wk", "wv", "wo")]
    if cfg.family == "gqa_moe":
        names += [("moe", n, 0) for n in ("gate", "up", "down")]
    else:
        names += [("mlp", n, None) for n in ("gate", "up", "down")
                  if n != "gate" or cfg.gated_mlp]
    rows = []
    for grp, name, expert in names:
        lps = [blk[grp][name] if expert is None
               else getattr(blk[grp], name)[expert]
               for blk in (merged.blocks[0], params.blocks[0])]
        (qm, qa), ad = (schemes.quantized_base(lp) for lp in lps), \
            schemes.adapter_params(lps[1])
        kw = dict(bits=qm.bits, group_size=qm.group_size)
        for step, t in steps.items():
            m = t if expert is None else _moe_capacity(cfg, t)
            x = torch.randn((m, qm.d_in), generator=gen, device="cuda") \
                .to(torch.bfloat16)
            gemv = m <= GEMV_MAX_M
            calls = [((qmatvec_cuda, qmatvec_plain) if gemv
                      else (qmatmul_cuda, qmatmul_plain),
                      (x, qm.qweight, qm.scale, qm.zero), kw)]
            if step != "ragged":  # the merge check's unmerged passes
                calls.append(((qalora_matvec_cuda, qalora_matvec_plain)
                              if gemv else (qalora_matmul_cuda,
                                            qalora_matmul_plain),
                              (x, qa.qweight, qa.scale, qa.zero, ad.a,
                               ad.b), dict(s=lps[1].policy.s, **kw)))
            for (kern, plain), args, kargs in calls:
                y = kern(*args, **kargs).float()
                ref = plain(*args, **kargs).float()
                err = (y - ref).abs().max().item()
                tol = 2.0 ** -6 * ref.abs().max().item()
                rows.append({
                    "kernel": kern.__name__.replace("_cuda", ""),
                    "linear": f"{grp}/{name}" + (
                        "" if expert is None else f"/{expert}"),
                    "step": step, "M": m, "K": qm.d_in, "N": qm.d_out,
                    "bits": qm.bits,
                    "max_abs_err": err, "tol": tol,
                    "ok": bool(torch.isfinite(y).all()) and err <= tol})
                del y, ref
    return rows


def _faulty_merge_check(torch, lm, params, merged, prompts, max_len,
                        fault: float):
    """The negative control of an MoE merge check: ``serve.merge_check``
    again with every merged expert's output times (1 + ``fault`` x normal
    noise) from a seeded generator, a stand-in for a kernel that goes
    wrong on the experts' rows; the adapter model is left sound."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(7)
    sound = moe._expert_ffn

    def faulty(p, e, xb, act):
        y = sound(p, e, xb, act)
        if p.gate[e].scheme != "intq":
            return y
        noise = torch.randn(y.shape, generator=gen, device=y.device)
        return (y.float() * (1.0 + fault * noise)).to(y.dtype)
    moe._expert_ffn = faulty
    try:
        return serve.merge_check(lm, params, merged, prompts, max_len,
                                 device="cuda")
    finally:
        moe._expert_ffn = sound


def _family_engines(torch, cfg, lm, merged, n_lin):
    """The continuous engine on ``FAMILY_REQUESTS`` requests over 4 slots
    (chunks of 64, bursts of 8), contiguous and paged: each graphed engine
    warmed by a first pass and then counted, and an eager one of each
    layout, whose streams must equal the graphed one's (for an MoE the
    contiguous eager run records the routing: the dropped share a step).
    The paged streams equal the contiguous ones for a dense model; for an
    MoE that is a reading, since a padding row reads stale rows in one
    layout and the null page in the other, and padding rows take
    capacity."""
    from repro_torch import kernels
    from repro_torch.models.moe import record_routing
    from repro_torch.runtime.compile_guard import CompileGuard
    from repro_torch.serving import ContinuousEngine, make_trace
    trace = make_trace(FAMILY_REQUESTS, cfg.vocab, **FAMILY_TRACE)
    kw = dict(n_slots=RAGGED_SLOTS, prefill_chunk=RAGGED_CHUNK,
              decode_burst=8, max_len=max(FAMILY_TRACE["prompt_lens"])
              + max(FAMILY_TRACE["gen_lens"]))
    layouts = {"contiguous": kw, "paged": dict(page_size=PAGE_SIZE, **kw)}
    moe = cfg.family == "gqa_moe"
    out, streams = {}, {}
    with CompileGuard(f"chip_smoke families {cfg.name}") as guard:
        for name, lkw in layouts.items():
            eng = ContinuousEngine(lm, merged, **lkw)
            _engine_pass(torch, eng, trace)  # captures every step it meets
            kernels.reset_launches()
            got, st, peak = _engine_pass(torch, eng, trace)
            counts = kernels.launches()
            captures, budgets = _graph_captures(eng), dict(eng.budgets)
            del eng
            _free(torch)
            eager = ContinuousEngine(lm, merged, eager=True, **lkw)
            recording = moe and name == "contiguous"
            with (record_routing() if recording
                  else contextlib.nullcontext([])) as rec, \
                    (_record_rows(lm) if recording
                     else contextlib.nullcontext([])) as rows:
                got_e, st_e, _ = _engine_pass(torch, eager, trace)
            del eager
            _free(torch)
            decode_steps = st.model_steps - RAGGED_CHUNK * st.ragged_dispatches
            streams[name] = got
            out[name] = {
                "launches": counts, "captures": captures,
                "budgets": budgets,
                "ragged_dispatches": st.ragged_dispatches,
                "decode_steps": decode_steps, "tokens_out": st.tokens_out,
                "occupancy": st.occupancy, "pass_peak_gb": peak,
                "graphed": _step_walls(st, RAGGED_CHUNK, FAMILY_REQUESTS),
                "eager": _step_walls(st_e, RAGGED_CHUNK, FAMILY_REQUESTS),
                "checks": {
                    "graphed_and_eager_streams_identical": got == got_e,
                    "all_requests_served": sorted(got) == sorted(
                        r.rid for r in trace),
                    "tiled_per_ragged_step":
                        counts["qmatmul"] == n_lin * st.ragged_dispatches,
                    "gemv_per_decode_step":
                        counts["qmatvec"] == n_lin * decode_steps,
                    "no_adapter_kernel": all(
                        v == 0 for k, v in counts.items()
                        if k not in ("qmatmul", "qmatvec")),
                    "captures_within_budget": all(
                        1 <= captures[k] <= b for k, b in budgets.items())}}
            if recording:
                out[name]["dropped_share"] = _drop_shares(
                    torch, rec, rows, cfg.n_layers, cfg.n_experts)
        guard_counts = guard.counts()
        guard.check()
    same = streams["paged"] == streams["contiguous"]
    out["paged_streams_equal_contiguous"] = same
    if not moe:
        out["paged"]["checks"]["paged_streams_equal_contiguous"] = same
    out["guard_counts"] = {k: list(v) for k, v in guard_counts.items()}
    return out


def _family(torch, arch, layers):
    """One config at full width (``layers`` cuts the depth): built from
    seed 0 (adapters nudged, then merged), served statically, 4 x (128 +
    32), the decode step replayed (one capture, within the budget of a
    ``CompileGuard``), the counted pass with the merge check, then
    ``FAMILY_TIMED`` passes for medians; kernels 1-4 counted against
    linears a layer (from the config) x layers x steps; the floors of a
    decode step and of the prefill; then, for ``FAMILY_ENGINES``, the
    continuous engine."""
    from statistics import median
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.runtime.compile_guard import CompileGuard
    t_cfg = time.perf_counter()
    full = C.get(arch)
    cfg = full if layers is None else full.scaled(n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    lm, params, merged = serve.build_model(cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_cfg
    n_lin = _step_linears(cfg)
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(4, 128)).astype(np.int32)
    max_len = prompts.shape[1] + SERVE_GEN
    bound = serve.merge_bound(cfg)
    with CompileGuard(f"chip_smoke families static {arch}") as guard:
        gen = serve.make_graph_generator(lm, merged, prompts.shape, SERVE_GEN,
                                         max_len, device="cuda")
        first, _ = gen(prompts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        toks, times = gen(prompts)
        mcheck = serve.merge_check(lm, params, merged, prompts, max_len,
                                   device="cuda")
        torch.cuda.synchronize()
        counts = kernels.launches()
        passes = [times]
        same = [bool(np.array_equal(first, toks))]
        for _ in range(FAMILY_TIMED - 1):
            t2, w = gen(prompts)
            passes.append(w)
            same.append(bool(np.array_equal(t2, toks)))
        captures = gen.graphs._cache_size()
        guard.check()
    replays = _replay_profiles(torch, {"decode": gen.graphs})
    del gen
    _free(torch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_profile = _profile_prefill(torch, lm, merged, prompts)
    moe = cfg.family == "gqa_moe"
    held = _hold_family_linears(torch, cfg, params, merged, prompts.size,
                                arch in FAMILY_ENGINES)
    control = {f: _faulty_merge_check(torch, lm, params, merged, prompts,
                                      max_len, f)
               for f in (FAMILY_FAULTS if moe else ())}
    decode_bytes = _linear_bytes(merged) + (
        2 * cfg.n_layers * 4 * max_len * cfg.n_kv_heads * cfg.head_dim * 4)
    flops = _prefill_flops(cfg, *prompts.shape)
    floors = {"decode_step_ms": decode_bytes / PEAK_BYTES_S * 1e3,
              "decode_bound_by": "bytes", "decode_gb": decode_bytes / 1e9,
              "prefill_ms": max(flops / PEAK_BF16_FLOP_S,
                                decode_bytes / PEAK_BYTES_S) * 1e3,
              "prefill_bound_by": "operations"
              if flops / PEAK_BF16_FLOP_S > decode_bytes / PEAK_BYTES_S
              else "bytes", "prefill_tflop": flops / 1e12}
    decode_ms = median(w["decode_s"] * 1e3 / (SERVE_GEN - 1) for w in passes)
    prefill_ms = median(w["prefill_s"] * 1e3 for w in passes)
    checks = {
        "tokens_shape": list(toks.shape) == [4, SERVE_GEN],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab)).all()),
        "same_tokens_every_pass": all(same),
        "merge_finite": all(math.isfinite(r["max_abs_diff"])
                            for r in mcheck.values()),
        "merge_within_bound": all(r["rel"] <= bound
                                  for r in mcheck.values()),
        "decode_captured_once": captures == 1,
        "replay_launches_match_profiler": bool(replays) and all(
            r["match"] for r in replays.values()),
        "kernels_held_against_plain": bool(held) and all(
            r["ok"] for r in held),
        **_window_checks(counts, n_lin)}
    if moe:
        checks["merge_tokens_routed_alike"] = all(
            _routed_alike(r) for r in mcheck.values())
        checks["faulty_merge_rejected"] = not any(
            _moe_merge_ok(c, bound) for f, c in control.items()
            if f >= FAMILY_FAULT_REJECT)
    out = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "depth_cut": (f"{cfg.n_layers} of {full.n_layers} layers"
                         if layers is not None else "none"),
           "widths": {k: getattr(cfg, k) for k in (
               "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
               "vocab", "window", "gated_mlp", "act", "n_experts", "top_k",
               "moe_d_ff")},
           "linears_per_layer": n_lin // cfg.n_layers,
           "linears_per_step": n_lin, "init_s": init_s,
           "peak_mem_gb": peak, "launches": counts,
           "decode_ms_per_token": decode_ms, "prefill_ms": prefill_ms,
           "passes": passes, "floors": floors,
           "decode_over_floor": decode_ms / floors["decode_step_ms"],
           "prefill_over_floor": prefill_ms / floors["prefill_ms"],
           "merge_check": mcheck, "merge_bound_rel": bound,
           "routing_rule": {"agree_min": FAMILY_AGREE_MIN,
                            "flip_max": FAMILY_FLIP_MAX},
           "faulty_merge_checks": [
               {"fault": f, "passes": _moe_merge_ok(c, bound), **c}
               for f, c in control.items()],
           "held": held,
           "replay_profiles": replays, "prefill_profile": prefill_profile,
           "sample_tokens": toks[0][:8].tolist()}
    del params
    _free(torch)
    if arch in FAMILY_ENGINES:
        out["engine"] = _family_engines(torch, cfg, lm, merged, n_lin)
        for layout in ("contiguous", "paged"):
            checks.update({f"engine_{layout}_{k}": v for k, v in
                           out["engine"][layout]["checks"].items()})
    del lm, merged
    _free(torch)
    out["checks"] = checks
    out["ok"] = all(checks.values())
    out["seconds"] = time.perf_counter() - t_cfg
    return out


def phase_families(torch):
    """The three dense gqa configs and mixtral-8x22b (gqa_moe) served at
    their published widths on the card (depth cuts in ``FAMILY_CUTS``):
    see :func:`_family`.  Returns the launch counts of each config's
    static window (and its engines' counted passes), and the rows of
    kernels 1-4 held against their plain versions."""
    t_phase = time.perf_counter()
    rows, counts, held = [], {}, []
    for arch, layers in FAMILY_CUTS:
        res = _family(torch, arch, layers)
        rows.append(res)
        held += res["held"]
        counts[f"{arch} static serve + merge check (phase families)"] = \
            res["launches"]
        for layout in ("contiguous", "paged"):
            if "engine" in res:
                counts[f"{arch} {layout} engine (phase families)"] = \
                    res["engine"][layout]["launches"]
        worst = max(r["max_abs_err"] / max(r["tol"], 1e-30)
                    for r in res["held"])
        mc = res["merge_check"]
        print(f"[chip_smoke] families: {arch} ({res['depth_cut']}): decode "
              f"{res['decode_ms_per_token']:.3f} ms a token "
              f"({res['decode_over_floor']:.2f}x its floor), prefill "
              f"{res['prefill_ms']:.2f} ms ({res['prefill_over_floor']:.2f}x)"
              f", merge rel {max(r['rel'] for r in mc.values()):.2e}"
              + (f", flipped {max(r['flip_share'] for r in mc.values()):.3%}"
                 if "flip_share" in mc["prefill"] else "")
              + f", {len(res['held'])} kernel holds, worst err/tol "
              f"{worst:.3f}"
              + f", ok {res['ok']}", flush=True)
    out = {"phase": "families", "configs": rows,
           "seconds": time.perf_counter() - t_phase,
           "ok": all(r["ok"] for r in rows)}
    emit(out)
    if not out["ok"]:
        bad = {r["arch"]: [k for k, v in r["checks"].items() if not v]
               for r in rows if not r["ok"]}
        raise AssertionError(f"families checks failed: {bad}")
    return counts, held

# ---------------------------------------------------------------------------
# phases 15-16: mixtral-8x22b trained, speculated and behind the frontend
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_LAYERS = "mixtral-8x22b", 16
# the main training run through launch/train.py: 8 x 256 tokens of alpaca
# a step, one routing group of T = 2048 rows (moe_chunk 512 > S), so each
# expert's capacity is C = ceil(2 x 2048 / 8 x 1.25) = 640; remat, 4
# steps, no checkpoint (its base/ would hold ~25 GB).  lr 2e-5, AdamW's
# default: at phase train's 2e-4 the random-weight mixtral diverged (loss
# 11.76 at step 0, 30.5 at step 4) and its merge flipped 14 % of the
# prefill's routings (H100 80GB HBM3, 700 W)
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--seq-len", "256", "--global-batch",
                  "8", "--dataset", "alpaca", "--lr", "2e-5", "--log-every",
                  "1", "--device", "cuda"]
MOE_TRAIN_STEPS = 4
# cut and resumed (phase_train) at 2 layers, whose base/ is ~3 GB
MOE_RESUME_LAYERS = 2
# speculation over the experts: k = 3 with a 2-bit drafter (an 8-bit one
# beside the int4 base would hold ~75 GB at 16 layers); 8 requests on 4
# slots; the verify step's experts see C = ceil(2 x 16 / 8 x 1.25) = 5
# rows and a drafter step's C = 2, so both run kernel 2
MOE_SPEC_DRAFTER = "*=intq2"
MOE_SPEC_REQUESTS = 8
# behind the frontend: the MoE and a dense config at full depth
MOE_FRONTEND_ARCHS = ((MOE_ARCH, MOE_LAYERS), ("h2o-danube-1.8b", None))


def _train_flops(cfg, b, s):
    """Operations of one remat train step of b x s tokens: every block's
    forward twice (the step and the recompute) and its backward's dx
    products once more (the base is frozen: no dW), the head over every
    token forward and backward; an MoE's experts at their capacity."""
    head_last = 2 * b * cfg.d_model * cfg.vocab
    return 3 * (_prefill_flops(cfg, b, s) - head_last) \
        + 2 * (head_last * s)


def _routing_record(torch, route, n_experts):
    """Dropped share and per-expert load of a training step's routing
    (``record_routing``, one entry a layer; every row is a real token)."""
    keep = torch.stack([r["keep"] for r in route])  # [L, B, S, k]
    idx = torch.stack([r["idx"] for r in route])
    return {"dropped_share": float((~keep).float().mean()),
            "dropped_share_by_layer": (~keep).float().mean(
                dim=(1, 2, 3)).tolist(),
            "routed_by_expert": torch.bincount(
                idx.reshape(-1), minlength=n_experts).tolist(),
            "dropped_by_expert": torch.bincount(
                idx[~keep], minlength=n_experts).tolist()}


def _merged_with(torch, params, tensors=None):
    """The merge of ``params`` with its adapters set to ``tensors`` (by
    name; None: every B zeroed, the adapters dropped), the adapters
    restored after."""
    from repro_torch.launch import serve
    from repro_torch.optim import trainable_tensors
    tr = trainable_tensors(params)
    kept = {k: t.detach().clone() for k, t in tr.items()}
    with torch.no_grad():
        for k, t in tr.items():
            if tensors is not None:
                t.copy_(tensors[k])
            elif k.endswith(".b"):
                t.zero_()
        try:
            return serve.merge_model(params)
        finally:
            for k, t in tr.items():
                t.copy_(kept[k])


# the f32 merge's gap to the adapter model, over the tokens routed alike,
# as a share of the adapter term's own (the adapters dropped): the merged
# zeros hold the fold to f32 rounding
MERGE_F32_GAP = 1e-2


def _merge_cpu_f32(torch, lm, params, prompts):
    """``params``'s merge in f32 on the CPU (a copy upcast, through the
    plain versions): the prefill logits at every position of the adapter
    model, its merge and the base with its adapters dropped; the merge
    and the base each against the adapter model over the tokens routed
    alike (``serve.compare_routed``), and the merge's gap over the
    base's (``merged_over_dropped``)."""
    from repro_torch.launch import serve
    from repro_torch.models.moe import record_routing
    t0 = time.perf_counter()
    cpu = copy.deepcopy(params).to("cpu").float()
    toks = torch.as_tensor(prompts, dtype=torch.int32)
    runs = {}
    for name, make in (("adapters", lambda: cpu),
                       ("merged", lambda: serve.merge_model(cpu)),
                       ("dropped", lambda: _merged_with(torch, cpu))):
        with torch.no_grad(), record_routing() as rec:
            runs[name] = (lm.prefill_all(make(), {"tokens": toks})[0], rec)
    ref, ref_route = runs.pop("adapters")
    out = {name: serve.compare_routed(
        logits, ref, serve.routing_agreement(ref_route, route))
        for name, (logits, route) in runs.items()}
    out["merged_over_dropped"] = (out["merged"]["max_abs_diff"]
                                  / max(out["dropped"]["max_abs_diff"],
                                        1e-30))
    out["prompts"] = list(prompts.shape)
    out["seconds"] = time.perf_counter() - t0
    return out


def _merge_precision(torch, params, merged, m=512):
    """The adapter term's size against the base product's, and the
    merged linear's gap to the unmerged one against the adapter term, on
    block 0's wq and expert 0's gate at ``m`` seeded rows (kernels 3 and
    1; the adapter term in plain f32)."""
    from repro_torch.core import schemes
    from repro_torch.core.qalora import adapter_delta
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for where, get in (("attn/wq", lambda b: b["attn"]["wq"]),
                       ("moe/gate/0", lambda b: b["moe"].gate[0])):
        lp, lm_ = get(params.blocks[0]), get(merged.blocks[0])
        qt, ad = schemes.quantized_base(lp), schemes.adapter_params(lp)
        x = torch.randn((m, qt.d_in), generator=gen,
                        device=qt.qweight.device).to(ad.a.dtype)
        with torch.no_grad():
            y_u = ops.qalora_matmul(x, qt, ad, lp.policy.s).float()
            term = adapter_delta(x.float(), ad, lp.policy.s, qt.group_size)
            base = ops.qmatmul(x, qt).float()
            y_m = ops.qmatmul(x, schemes.quantized_base(lm_)).float()
        out[where] = {"adapter_over_base": float(term.norm() / base.norm()),
                      "merged_gap_over_adapter":
                          float((y_m - y_u).norm() / term.norm())}
    return out


def _merge_routing(torch, lm, params, merged, prompts):
    """The merge check's prefill routing, layer by layer: the share of
    tokens whose experts differ between the adapter and the merged model,
    and of those routed to the same experts but kept or dropped otherwise
    (capacity: one token's flip moves every later assignment's position
    in its experts)."""
    from repro_torch.models.moe import record_routing
    toks = torch.as_tensor(prompts, dtype=torch.int32,
                           device=params.embed.device)
    routes = []
    for p in (params, merged):
        with record_routing() as rec:
            lm.prefill_all(p, {"tokens": toks})
        routes.append(rec)
    out = []
    for ra, rb in zip(*routes):
        (ia, oa), (ib, ob) = (r["idx"].sort(dim=-1) for r in (ra, rb))
        ka, kb = ra["keep"].gather(-1, oa), rb["keep"].gather(-1, ob)
        experts = ~(ia == ib).all(dim=-1)
        kept = ~experts & ~(ka == kb).all(dim=-1)
        out.append({"experts_differ": float(experts.float().mean()),
                    "keep_differs_only": float(kept.float().mean())})
    return out


def _fingerprint(torch, params):
    """Two integer sums over the bytes of each buffer of ``params`` (the
    frozen base, embedding, norms): plain and weighted by position mod a
    prime, so a changed byte changes them."""
    sums = []
    for t in params.buffers():
        b = t.detach().contiguous().view(-1).view(torch.uint8).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        sums += [b.sum(), (b * w).sum()]
        del b, w
    return torch.stack(sums).tolist()


def _profile_train_step(torch, st):
    """One more train step of ``st`` under ``torch.profiler``: wall ms
    (host clock, ending in a sync), device busy ms (the union of the
    device activities), the idle share and device ms by kind: kernel 3's
    tiled part, its rank projection 3a, PyTorch's matmuls (the plain
    backward's products, attention's, the router's) and everything
    else."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _device_us, _kind
    toks, labs = st.stream.next_batch()
    batch = {"tokens": torch.as_tensor(toks).to(st.device),
             "labels": torch.as_tensor(labs).to(st.device)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(st.step_fn(st.params, st.opt_state, batch)["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = {"qalora_matmul": "kernel 3", "qalora_rank_proj": "kernel 3a"}
    by_kind, n_kind = {}, {}
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        kind = names.get(_counter_of(evt.key)) or _kind(evt.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + _device_us(evt) / 1e3
        n_kind[kind] = n_kind.get(kind, 0) + evt.count
    busy, n_events = _busy_ms(prof)
    del prof
    return {"loss": loss, "wall_ms": wall, "device_busy_ms": busy,
            "device_events": n_events,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_ms_by_kind": by_kind, "device_kernels_by_kind": n_kind}


def phase_moe_train(torch):
    """mixtral-8x22b fine-tuned on the card at its published widths:
    ``launch/train.py``'s ``setup`` and ``run`` at ``MOE_LAYERS`` of 56
    layers (bf16, int4 g32 r64, remat), ``MOE_TRAIN_STEPS`` steps of 8 x
    256 tokens, counts reset just before the loop and read just after:
    kernel 3 and its projection 2 x 448 times a step (attention at M =
    2048, each expert at its capacity C = 640) and no other kernel; the
    first step's routing recorded (its dropped share).  The trainer
    starts from the adapters nudged as phase families serves them (the
    reference's stand-in for a fine-tune: from B = 0 the trained term is
    ~0.5 % of the base product and random routing ties flip ~20 % of the
    merge check's routings), and the merge of the trained adapters is held
    by ``serve.merge_check``: ``FAMILY_AGREE_MIN`` of the tokens routed
    alike at every layer and within ``serve.merge_bound`` over them
    (:func:`_moe_merge_close`), a gate that must reject the base with the
    adapters dropped; phase families' whole routed rule (also at most
    ``FAMILY_FLIP_MAX`` of the routings flipped) is a reading, and so is
    the merge of the adapters as they were before training (what the
    gate sees of 4 steps); kernels 3 and 3a held against their plain
    versions at the step's shapes (the experts' M = 640, K x N = 6144 x
    16384 and 16384 x 6144);
    a fifth step under ``torch.profiler``.  Then the cut-and-resume run of
    phase train at ``MOE_RESUME_LAYERS`` layers, and one step of a 2-layer
    mixtral on the card against the CPU in f32 (phase train_small, with
    the routing of both sides)."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import kernels
    from repro_torch.launch import serve, train
    from repro_torch.models.moe import record_routing
    from repro_torch.optim import trainable_tensors
    t_phase = time.perf_counter()
    ap = train.build_parser()
    args = ap.parse_args(MOE_TRAIN_ARGV + [
        "--n-layers", str(MOE_LAYERS), "--steps", str(MOE_TRAIN_STEPS)])
    t0 = time.perf_counter()
    st = train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, dev = st.cfg, st.device
    with torch.no_grad():
        serve.bump_adapters(st.params)
    untrained = {k: t.detach().clone()
                 for k, t in trainable_tensors(st.params).items()}
    # a copy of the base would double its ~25 GB (and the step's peak)
    base_before = _fingerprint(torch, st.params)
    inner, recorded = st.step_fn, {}

    def step_fn(params, opt_state, batch):
        if recorded:
            return inner(params, opt_state, batch)
        with record_routing() as route:
            metrics = inner(params, opt_state, batch)
        recorded["route"] = route
        return metrics
    st.step_fn = step_fn
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = train.run(st, args)
    torch.cuda.synchronize()
    counts = kernels.launches()
    st.step_fn = inner
    base_same = _fingerprint(torch, st.params) == base_before
    tokens = args.global_batch * args.seq_len
    per_step = _step_linears(cfg) * 2
    routing = _routing_record(torch, recorded.pop("route"), cfg.n_experts)
    prompts = np.random.default_rng(0).integers(
        4, cfg.vocab, size=(4, 128)).astype(np.int32)
    bound = serve.merge_bound(cfg)
    merged = serve.merge_model(st.params)
    kernels.reset_launches()
    mcheck = serve.merge_check(st.lm, st.params, merged, prompts, 129,
                               device=dev)
    merge_counts = kernels.launches()
    merge_flips = _merge_routing(torch, st.lm, st.params, merged, prompts)
    precision = _merge_precision(torch, st.params, merged)
    del merged
    controls = {}
    for name, tensors in (("adapters_dropped", None),
                          ("untrained_adapters", untrained)):
        wrong = _merged_with(torch, st.params, tensors)
        controls[name] = serve.merge_check(st.lm, st.params, wrong, prompts,
                                           129, device=dev)
        controls[name].update(
            passes_gate=_moe_merge_close(controls[name], bound),
            passes_rule=_moe_merge_ok(controls[name], bound))
        del wrong
    del untrained
    _free(torch)
    print(f"[chip_smoke] moe_train: merge check {json.dumps(mcheck)}; "
          f"controls {json.dumps(controls)}; {json.dumps(precision)}",
          flush=True)
    timing, at_m = _train_linears_at_m(torch, cfg, st.params, tokens)
    profile = _profile_train_step(torch, st)
    flops = _train_flops(cfg, args.global_batch, args.seq_len)
    med = res["step_ms_median"]
    del st, res["state"], inner, step_fn
    _free(torch)
    print(f"[chip_smoke] moe_train: {MOE_ARCH} ({MOE_LAYERS} layers) "
          f"{tokens} tokens a step: {med:.1f} ms median, "
          f"{res['tokens_per_s']:.0f} tokens/s, peak "
          f"{(res['peak_mem_bytes'] or 0) / 1e9:.2f} GB, loss {res['loss']}, "
          f"aux {res['aux']}, dropped {routing['dropped_share']:.3f}, idle "
          f"{profile['device_idle_share']:.3f}", flush=True)
    # the 2-layer runs each emit their own line; a failure of one is
    # raised after this phase's line is out
    failed, resume_counts, resume_errs = [], {}, {}
    try:
        resume_counts, resume_errs = phase_train(
            torch, argv=MOE_TRAIN_ARGV + [
                "--n-layers", str(MOE_RESUME_LAYERS), "--ckpt-every", "2"],
            steps=4, resume_at=2, phase="moe_train_resume",
            hold_kernels=False)
    except AssertionError as e:
        failed.append(str(e))
    try:
        phase_train_small(torch, arch=MOE_ARCH, phase="moe_train_small")
    except AssertionError as e:
        failed.append(str(e))
    layer = {k: v for k, v in timing.items() if k != "per_linear"}
    checks = {
        "losses_finite": all(math.isfinite(x) for x in res["loss"]
                             + res["xent"] + res["aux"]),
        "loss_is_xent_plus_aux": all(
            abs(lo - (x + cfg.aux_coef * a)) <= 1e-5 * abs(lo)
            for lo, x, a in zip(res["loss"], res["xent"], res["aux"])),
        "base_fingerprint_unchanged": base_same,
        "kernel3_and_3a_per_step": all(
            s[k] == per_step for s in res["launches"] for k in TRAIN_PATH),
        "no_other_kernel_in_a_step": all(
            v == 0 for s in res["launches"] for k, v in s.items()
            if k not in TRAIN_PATH),
        "path_kernels_launched": all(counts[k] > 0 for k in TRAIN_PATH),
        "merge_tokens_alike_and_within_bound": _moe_merge_close(mcheck,
                                                                bound),
        "merge_gate_rejects_adapters_dropped":
            not controls["adapters_dropped"]["passes_gate"],
        "merge_path_kernels_launched": all(
            merge_counts[k] > 0 for k in MERGE_PATH),
        "kernel3_and_3a_at_train_shapes_within_bound":
            {r["kernel"] for r in at_m} == set(TRAIN_PATH)
            and all(r["ok"] for r in at_m)
            and {r["M"] for r in at_m} == {tokens, _moe_capacity(cfg,
                                                                 tokens)},
        "profiled_step_finite": math.isfinite(profile["loss"]),
    }
    out = {"phase": "moe_train", "card": _smi("name,power.limit"),
           "arch": cfg.name, "n_layers": cfg.n_layers,
           "depth_cut": f"{cfg.n_layers} of {C.get(MOE_ARCH).n_layers} "
                        f"layers",
           "batch": [args.global_batch, args.seq_len],
           "dataset": args.dataset, "lr": args.lr, "steps": MOE_TRAIN_STEPS,
           "capacity": _moe_capacity(cfg, tokens), "setup_s": setup_s,
           "loss": res["loss"], "xent": res["xent"], "aux": res["aux"],
           "grad_norm": res["grad_norm"], "step_ms": res["step_ms"],
           "step_ms_median_after_first": med,
           "tokens_per_s": res["tokens_per_s"],
           "peak_mem_gb": (res["peak_mem_bytes"] or 0) / 1e9,
           "step_tflop": flops / 1e12,
           "step_floor_ms": flops / PEAK_BF16_FLOP_S * 1e3,
           "over_floor": med / (flops / PEAK_BF16_FLOP_S * 1e3),
           "launches": counts, "launches_per_step": res["launches"],
           "launches_expected_per_step": per_step,
           "routing_first_step": routing,
           "start": "adapters nudged by +0.01 (serve.bump_adapters)",
           "merge_check": mcheck, "merge_bound_rel": bound,
           "merge_routed_rule_met": _moe_merge_ok(mcheck, bound),
           "merge_controls": controls,
           "merge_routing_by_layer": merge_flips,
           "merge_precision": precision,
           "routing_rule": {"agree_min": FAMILY_AGREE_MIN,
                            "flip_max": FAMILY_FLIP_MAX},
           "merge_launches": merge_counts,
           "per_layer_ms_at_train_shapes": layer,
           "per_linear": timing["per_linear"], "kernels_at_M": at_m,
           "step_share": {
               "kernel3_ms": layer["kernel3_fwd_ms"] * cfg.n_layers * 2,
               "plain_bwd_linears_ms": layer["plain_bwd_ms"] * cfg.n_layers,
               "bwd_dx_product_ms":
                   layer["bwd_dx_product_ms"] * cfg.n_layers},
           "profiled_step": profile, "checks": checks,
           "phase_s": time.perf_counter() - t_phase}
    out["ok"] = all(checks.values()) and not failed
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"moe_train checks failed: "
                             f"{[k for k, v in checks.items() if not v]}"
                             + "".join(f"; {f}" for f in failed))
    errs = {k: max([r["max_abs_err"] for r in at_m if r["kernel"] == k]
                   + [resume_errs.get(k, 0.0)]) for k in TRAIN_PATH}
    return _sum_counts([counts, merge_counts, resume_counts]), errs


def _hold_gemv_experts(torch, blk, m, gen):
    """Kernel 2 on block ``blk``'s expert 0 gate, up and down at M = ``m``
    rows against its plain version (two bf16 steps of the plain version's
    max)."""
    from repro_torch.core import schemes
    from repro_torch.kernels.qmatvec import qmatvec_cuda, qmatvec_plain
    rows = []
    for name in ("gate", "up", "down"):
        qt = schemes.quantized_base(getattr(blk["moe"], name)[0])
        args = (qt.qweight, qt.scale, qt.zero)
        kw = dict(bits=qt.bits, group_size=qt.group_size)
        x = torch.randn((m, qt.d_in), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        y = qmatvec_cuda(x, *args, **kw).float()
        ref = qmatvec_plain(x, *args, **kw).float()
        err = (y - ref).abs().max().item()
        tol = 2.0 ** -6 * ref.abs().max().item()
        rows.append({"kernel": "qmatvec", "linear": f"moe/{name}/0",
                     "bits": qt.bits, "M": m, "K": qt.d_in, "N": qt.d_out,
                     "max_abs_err": err, "tol": tol,
                     "ok": bool(torch.isfinite(y).all()) and err <= tol})
    return rows


def _moe_spec(torch, cfg, lm, merged):
    """Self-speculation over mixtral's experts: a plain graphed engine
    (bursts of 8) and speculating engines (k = 3, one shared 2-bit drafter
    tree), contiguous and paged, each warmed by a first pass; the
    contiguous one counted (reset just before its pass, read just after);
    the three graphed engines one timed pass each for their ms a committed
    token; each speculating layout again eager, streams equal to its
    graphed engine's; kernel 2 held at the verify step's and a drafter
    step's expert rows."""
    from statistics import median
    from repro_torch import kernels
    from repro_torch.runtime.compile_guard import CompileGuard
    from repro_torch.serving import (ContinuousEngine, make_self_drafter,
                                     make_trace)
    trace = make_trace(MOE_SPEC_REQUESTS, cfg.vocab, **FAMILY_TRACE)
    kw = dict(n_slots=RAGGED_SLOTS, prefill_chunk=RAGGED_CHUNK,
              max_len=max(FAMILY_TRACE["prompt_lens"])
              + max(FAMILY_TRACE["gen_lens"]) + SPEC_K)
    spec = dict(decode_burst=1, speculate=SPEC_K, **kw)
    t0 = time.perf_counter()
    draft = make_self_drafter(merged, MOE_SPEC_DRAFTER,
                              base=cfg.quant.default)
    torch.cuda.synchronize()
    draft_s = time.perf_counter() - t0
    layouts = {"contiguous": {}, "paged": {"page_size": PAGE_SIZE}}
    make = {"plain": lambda: ContinuousEngine(lm, merged, decode_burst=8,
                                              **kw)}
    for name, lkw in layouts.items():
        make[name] = (lambda lkw=lkw: ContinuousEngine(
            lm, merged, drafter=draft, **spec, **lkw))
    with CompileGuard("chip_smoke moe spec") as guard:
        engines, first, held_mem = _built_engines(torch, make, trace)
        kernels.reset_launches()
        got, est, _ = _engine_pass(torch, engines["contiguous"], trace)
        counts = kernels.launches()
        captures = {n: _graph_captures(e) for n, e in engines.items()}
        budgets = {n: dict(e.budgets) for n, e in engines.items()}
        runs = {n: [] for n in engines}
        for name in engines:  # one timed pass each, after the warm ones
            o, s, _ = _engine_pass(torch, engines[name], trace)
            runs[name].append({
                "same": o == first[name][0],
                "acceptance_rate": s.acceptance_rate,
                **_step_walls(s, RAGGED_CHUNK, MOE_SPEC_REQUESTS)})
        guard_counts = guard.counts()
        guard.check()
    stats = {n: {"acceptance_rate": e.stats.acceptance_rate,
                 "proposed_tokens": e.stats.proposed_tokens,
                 "accepted_tokens": e.stats.accepted_tokens,
                 "tokens_out": e.stats.tokens_out}
             for n, e in engines.items()}
    # admissions the paged pool refused (over the warm and the timed
    # pass): a backoff changes the batches, and with them the routing
    backoffs = engines["paged"].page_table.alloc_backoffs
    streams = {n: first[n][0] for n in engines}
    del engines
    _free(torch)
    eager = {}
    for name, lkw in layouts.items():
        eng = ContinuousEngine(lm, merged, drafter=draft, eager=True,
                               **spec, **lkw)
        o, s, _ = _engine_pass(torch, eng, trace)
        eager[name] = {"same_as_graphed": o == streams[name],
                       **_step_walls(s, RAGGED_CHUNK, MOE_SPEC_REQUESTS)}
        del eng
        _free(torch)
    gen = torch.Generator(device="cuda").manual_seed(9)
    verify_c = _moe_capacity(cfg, RAGGED_SLOTS * (SPEC_K + 1))
    draft_c = _moe_capacity(cfg, RAGGED_SLOTS)
    held = (_hold_gemv_experts(torch, merged.blocks[0], verify_c, gen)
            + _hold_gemv_experts(torch, draft.blocks[0], draft_c, gen))
    del draft
    _free(torch)
    walls = {n: {key: median(r[key] for r in rs) for key in rs[0]
                 if key != "same"} for n, rs in runs.items()}
    n_attn, n_lin = 4 * cfg.n_layers, _step_linears(cfg)
    ragged = est.ragged_dispatches
    rounds = (est.model_steps - RAGGED_CHUNK * ragged) // (SPEC_K + 1)
    # ragged steps (target and drafter ride-along, experts at C = 80):
    # kernel 1; a verify step: attention at M = 16 through kernel 1, the
    # experts at C = 5 through kernel 2; k + 1 drafter steps a round at
    # M = 4, experts at C = 2: kernel 2
    want = {"qmatmul": n_lin * 2 * ragged + n_attn * rounds,
            "qmatvec": (n_lin - n_attn) * rounds
            + n_lin * (SPEC_K + 1) * rounds}
    served = sorted(r.rid for r in trace)
    checks = {
        "every_request_served": all(sorted(st) == served
                                    for st in streams.values()),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for st in streams.values()
                               for toks in st.values() for t in toks),
        "every_pass_same_streams": got == streams["contiguous"]
        and all(r["same"] for rs in runs.values() for r in rs),
        "eager_equals_graphed": all(e["same_as_graphed"]
                                    for e in eager.values()),
        "drafts_proposed": all(stats[n]["proposed_tokens"] > 0
                               for n in layouts),
        "launches_as_predicted": all(counts[k] == want.get(k, 0)
                                     for k in counts),
        "verify_experts_run_kernel_2": verify_c <= GEMV_MAX_M
        and draft_c <= GEMV_MAX_M,
        "captures_within_budget": all(
            1 <= captures[n][k] <= b for n in captures
            for k, b in budgets[n].items()),
        "kernel_2_held": all(r["ok"] for r in held),
        # the same batches step for step unless the pool backed off
        "paged_equals_contiguous_without_backoffs": backoffs > 0
        or streams["paged"] == streams["contiguous"],
    }
    same_plain = {n: sum(streams[n][r] == streams["plain"][r]
                         for r in served) / len(served) for n in layouts}
    return {"requests": MOE_SPEC_REQUESTS, "trace": dict(FAMILY_TRACE),
            "speculate": SPEC_K, "drafter": MOE_SPEC_DRAFTER,
            "drafter_build_s": draft_s, "verify_capacity": verify_c,
            "draft_capacity": draft_c, "launches": counts,
            "launches_expected": want, "rounds": rounds,
            "ragged_dispatches": ragged, "walls": walls, "eager": eager,
            "stats": stats, "engine_memory": held_mem,
            "captures": captures, "budgets": budgets,
            "guard": {k: list(v) for k, v in guard_counts.items()},
            "held": held,
            "requests_equal_plain_stream": same_plain,
            "paged_equals_contiguous": streams["paged"]
            == streams["contiguous"], "paged_backoffs": backoffs,
            "streams_note": "capacity routing: a verify step routes B (k+1) "
                            "rows and a drafter step B, so an MoE's "
                            "speculating streams need not equal plain "
                            "decode's (the CPU tests hold them to the "
                            "reference's)",
            "checks": checks}


def _moe_frontend(torch, arch, layers):
    """One config behind ``ServingFrontend``: phase frontend's (a), a
    plain engine, a clean and a faulty frontend (a crash at dispatch 3, a
    NaN at 7), gated by :func:`_recovery_checks` (``routed`` for an MoE);
    then the calibration and one clean Poisson SLO run at 0.7 x capacity
    under ``torch.profiler`` (TTFT, TPOT, goodput, the idle share)."""
    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.serving import make_trace, poisson_arrivals
    t0 = time.perf_counter()
    full = C.get(arch)
    cfg = full if layers is None else full.scaled(n_layers=layers)
    lm, params, merged = serve.build_model(cfg, "cuda")
    del params
    _free(torch)
    routed = cfg.family == "gqa_moe"
    per_step = _step_linears(cfg)
    trace, plain, rec = _frontend_recovery(torch, cfg, lm, merged)
    checks = _recovery_checks(rec, plain, per_step, routed=routed)
    checks["recovery_no_capture_after_first_pass"] = all(
        r["captures_after"] == r["captures_warm"] for r in rec.values())
    slo_trace = make_trace(SLO_REQUESTS, cfg.vocab, **SLO_TRACE)
    max_len = max(SLO_TRACE["prompt_lens"]) + max(SLO_TRACE["gen_lens"])
    calibration, rate, deadline = _slo_calibrate(torch, cfg, lm, merged,
                                                 max_len)
    traced = _slo_run(torch, lm, merged, slo_trace,
                      poisson_arrivals(SLO_REQUESTS, rate, seed=1),
                      max_len=max_len, deadline=deadline, profiled=True)
    checks.update({
        "slo_thread_ended": calibration["thread_ended"]
        and traced["thread_ended"],
        "slo_no_failed_ticket": "FAILED" not in traced["statuses"],
        "slo_no_recovery": traced["slo"]["recoveries"] == 0,
        "slo_some_finished": traced["slo"]["finished"] > 0,
        "slo_no_capture_in_run": traced["captures_after"]
        == traced["captures_warm"]
        and calibration["captures_after"] == calibration["captures_warm"],
        "slo_only_path_kernels": all(
            v == 0 for k, v in traced["launches"].items()
            if k not in PTQ_PATH)})
    if not routed:
        # a dense model's tokens are its plain engine's whatever the batch
        slo_plain = _engine_streams(lm, merged, slo_trace, max_len=max_len,
                                    **FE_ENGINE)
        checks["slo_tokens_prefix_of_plain"] = _prefix_ok(traced["tokens"],
                                                          slo_plain)
    del lm, merged
    _free(torch)
    faulty = rec["faulty"]
    identical = sum(faulty["tokens"][r] == rec["clean"]["tokens"][r]
                    for r in faulty["tokens"]) / len(faulty["tokens"])
    for r in rec.values():
        r["tokens"] = {str(k): v[:8] for k, v in r["tokens"].items()}
    traced["tokens"] = len(traced["tokens"])
    s = traced["slo"]
    print(f"[chip_smoke] moe_serve frontend {arch}: recovered tickets "
          f"identical to the clean run {identical:.3f}; Poisson clean at "
          f"{rate:.3f} req/s: ttft p50/p99 {s['ttft_p50_s'] * 1e3:.1f}/"
          f"{s['ttft_p99_s'] * 1e3:.1f} ms, tpot p50/p99 "
          f"{s['tpot_p50_s'] * 1e3:.2f}/{s['tpot_p99_s'] * 1e3:.2f} ms, "
          f"goodput {s['goodput_tok_s']:.1f} tok/s, idle "
          f"{traced['device_idle_share']:.3f}", flush=True)
    return {"arch": arch, "n_layers": cfg.n_layers,
            "depth_cut": (f"{cfg.n_layers} of {full.n_layers} layers"
                          if layers else "none"),
            "recovery": rec, "faulty_tickets_identical_to_clean": identical,
            "calibration": calibration, "traced": traced,
            "seconds": time.perf_counter() - t0, "checks": checks}


def phase_moe_serve(torch):
    """mixtral-8x22b at ``MOE_LAYERS`` layers speculated (:func:`_moe_spec`)
    and, with h2o-danube-1.8b whole, behind the frontend
    (:func:`_moe_frontend`).  Returns the launch counts of each counted
    window and the kernel rows held."""
    import repro_torch.configs as C
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    cfg = C.get(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    lm, params, merged = serve.build_model(cfg, "cuda")
    del params
    _free(torch)
    spec = _moe_spec(torch, cfg, lm, merged)
    del lm, merged
    _free(torch)
    w = spec["walls"]
    print(f"[chip_smoke] moe_serve spec: ms a committed token plain "
          f"{w['plain']['decode_ms_per_token']:.3f}, "
          + ", ".join(f"{n} {w[n]['decode_ms_per_token']:.3f} (acceptance "
                      f"{spec['stats'][n]['acceptance_rate']:.3f})"
                      for n in ("contiguous", "paged")), flush=True)
    fronts = [_moe_frontend(torch, arch, layers)
              for arch, layers in MOE_FRONTEND_ARCHS]
    out = {"phase": "moe_serve", "card": _smi("name,power.limit"),
           "arch": MOE_ARCH, "n_layers": MOE_LAYERS,
           "depth_cut": f"{MOE_LAYERS} of {C.get(MOE_ARCH).n_layers} layers",
           "spec": spec, "frontend": fronts,
           "phase_s": time.perf_counter() - t_phase}
    checks = {f"spec_{k}": v for k, v in spec["checks"].items()}
    for f in fronts:
        checks.update({f"{f['arch']}_{k}": v for k, v in f["checks"].items()})
    out["checks"] = checks
    out["ok"] = all(checks.values())
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"moe_serve checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    counts = {f"mixtral speculative serve, {MOE_SPEC_DRAFTER} drafter "
              f"(phase moe_serve)": spec["launches"]}
    for f in fronts:
        counts[f"{f['arch']} frontend recovery (phase moe_serve)"] = \
            _sum_counts(r["launches"] for r in f["recovery"].values())
        counts[f"{f['arch']} frontend SLO run (phase moe_serve)"] = \
            f["traced"]["launches"]
    return counts, spec["held"]


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
        adapter_counts, adapter_toks = phase_adapters(torch)
        counts.update({k: v for k, v in adapter_counts.items()
                       if k not in STATIC_PATH})
        paged_counts, paged_tenant_counts = phase_paged(torch, adapter_toks)
        spec_counts, spec_held = phase_spec(torch)
        frontend_counts = phase_frontend(torch, adapter_toks)
        serve_counts = {"paged serve (phase paged)": paged_counts,
                        "paged multi-tenant serve (phase paged)":
                            paged_tenant_counts,
                        f"speculative serve, {SPEC_DRAFTERS[0]} drafter "
                        f"(phase spec)": spec_counts, **frontend_counts}
        phase_train_small(torch)
        train_counts, train_errs = phase_train(torch)
        base_counts, head_rows = phase_baselines(torch)
        family_counts, family_held = phase_families(torch)
        serve_counts.update(family_counts)
        moe_train_counts, moe_train_errs = phase_moe_train(torch)
        moe_serve_counts, moe_held = phase_moe_serve(torch)
        serve_counts.update(moe_serve_counts)
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
        spec = [x for rs in spec_held.values() for x in rs
                if x["kernel"] == name]
        fam = [x for x in family_held + moe_held if x["kernel"] == name]
        held = spec + fam
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[name] + train_counts.get(name, 0)
            + moe_train_counts.get(name, 0)
            + sum(c[name] for c in base_counts.values())
            + sum(c[name] for c in serve_counts.values()),
            "max_abs_err": max([x["max_abs_err"]
                                for x in r + ragged.get(name, []) + held]
                               + [train_errs.get(name, 0.0),
                                  moe_train_errs.get(name, 0.0)]
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
            "launches_path": ("continuous multi-tenant serve (phase "
                              "adapters)" if name not in STATIC_PATH
                              else "static serve (phase serve)")
            + (f"; {FRONTEND_PATH[name]} (phase frontend)"
               if name in FRONTEND_PATH else ""),
            "status": "ported, checked"})
        summary[-1]["launches_by_path"] = {
            (("static serve (phase serve)" if name in STATIC_PATH
              else "continuous multi-tenant serve (phase adapters)")):
                counts[name],
            **{path: c[name] for path, c in serve_counts.items()}}
        if name in STATIC_PATH:
            summary[-1]["launches_by_path"].update({
                f"train, {TRAIN_STEPS} steps (phase train)":
                    train_counts[name],
                "mixtral train, merge check and resumed run (phase "
                "moe_train)": moe_train_counts[name],
                **{f"{path} (phase baselines)": c[name]
                   for path, c in base_counts.items()}})
        if spec:
            summary[-1]["spec_shapes_held"] = sorted(
                {f"M={x['M']} bits={x['bits']}" for x in spec})
        if fam:
            summary[-1]["families_and_moe_shapes_held"] = sorted(
                {f"M={x['M']} K={x['K']} N={x['N']}" for x in fam})
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
        + moe_train_counts[PROJ[0]]
        + sum(c[PROJ[0]] for c in base_counts.values())
        + sum(c[PROJ[0]] for c in serve_counts.values()),
        "launches_by_path": {
            "static serve (phase serve)": counts[PROJ[0]],
            f"train, {TRAIN_STEPS} steps (phase train)":
                train_counts[PROJ[0]],
            "mixtral train, merge check and resumed run (phase moe_train)":
                moe_train_counts[PROJ[0]],
            **{f"{path} (phase baselines)": c[PROJ[0]]
               for path, c in base_counts.items()},
            **{path: c[PROJ[0]] for path, c in serve_counts.items()}},
        "max_abs_err": max([x["max_abs_err"] for x in r + ragged[PROJ[0]]]
                           + [train_errs[PROJ[0]], moe_train_errs[PROJ[0]]]),
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
        "replaces": SLOT_PROJ[2], "launches": counts[SLOT_PROJ[0]]
        + sum(c[SLOT_PROJ[0]] for c in serve_counts.values()),
        "max_abs_err": max(x["max_abs_err"] for x in r),
        **{f"{key}_ms": _per_layer(r, f"{key}_ms")
           for key in ("plain", "library")},
        "ms": _per_layer(r, "kernel_ms"), "bound_ms": _per_layer(r, "bound_ms"),
        "bound_by": r[0]["bound_by"],
        "work": f"kernel 5's first launch, t[i] = bf16(pool_g(x[i]) @ "
                f"A[ids[i]]), for one layer's linears at M={GEMV_M}, ids "
                f"{SLOT_IDS[GEMV_M]} over a {SLOT_BANK_ROWS}-row bank: 6 at "
                f"K=4096, 1 at K=11008, r {RANK}",
        "launches_path": "continuous multi-tenant serve (phase adapters) "
                         "and the frontend's tenants' recovery (phase "
                         "frontend): one per kernel 5 launch",
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
