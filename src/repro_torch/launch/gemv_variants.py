"""Variants of the decode GEMV (``csrc/qmatvec.cu``: kernels 2, 4 and 5),
built side by side and timed per llama7b-proxy layer on the card.

    python -m repro_torch.launch.gemv_variants
    python -m repro_torch.launch.gemv_variants --variants committed --m 4 \
        --modes base,adapter,adapter_t,slot,slot_t,proj,slot_proj

Each variant is the committed source with a few lines replaced (none for
``committed``; ``serial`` launches the projection and the GEMV in plain
stream order instead of as programmatic dependents), plus two C entries
that only this tool builds (``T_ENTRIES``: the adapter and slot GEMV on a
given t).  Every built variant is timed in each of the modes asked for
(default base, adapter and slot):

- ``base``: kernel 2 (``qmatvec_bf16``);
- ``adapter``: kernel 4, the projection and the GEMV in one host call;
  ``adapter_t``: the GEMV alone on a given t (no projection);
- ``slot``: kernel 5 with ids [1, 2, 0, 3] (M 4; [1] at M 1,
  [1, 2, 0, 3, 4, 1, 0, 2] at M 8) over a 5-row bank;
  ``slot_t``: the slot GEMV alone on a given t; ``slot_one``: every row
  on bank row 1 (one adapter's bytes); ``slot_null`` and ``slot_t_null``:
  every row on the null adapter;
- ``proj`` and ``slot_proj``: the projections alone, as kernels 4 and 5
  launch them (their outputs are checked against their plain versions).

Ablations (the B epilogue dropped, ...) give wrong outputs and are not
checked; the other variants are held against the plain version, as the
ratio of max|y - plain| to 2**-6 * max|plain|.  Int4 g32, bf16 scales,
r 64, at M in ``--m`` (default 1, 4, 8).  Each time is device time: a
CUDA graph of ``ITERS`` calls rotating over weight copies that keep the
50 MB L2 cold, replayed once under CUDA events.  The library call
(cuBLAS on the pre-dequantised weight) is timed the same way in the same
run.  Variants and rounds are taken in turn.  Prints one JSON line per
variant and round, and the ptxas registers and spills of the served
instantiations; writes them all to ``--out``.
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
from ..kernels.qalora_fused import qalora_rank_proj_plain
from ..kernels.qmatvec import (qalora_matvec_plain, qalora_slot_matvec_plain,
                               qalora_slot_rank_proj_plain, qmatvec_plain)

ROUNDS = 2
ITERS = 50
GROUP, RANK, S_ADAPTER, BANK_ROWS = 32, 64, 2.0, 5
SLOT_IDS = {1: [1], 4: [1, 2, 0, 3], 8: [1, 2, 0, 3, 4, 1, 0, 2]}
# one layer's linears: (K, N, count)
SHAPES = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
MODES = ("base", "adapter", "adapter_t", "slot", "slot_t", "slot_t_null",
         "slot_one", "slot_null", "proj", "slot_proj")
# ptxas entries of the served instantiations (int4, bf16 scales)
ENTRIES = {"base": "gemv_kernelILi4E13__nv_bfloat16Li0E",
           "adapter": "gemv_kernelILi4E13__nv_bfloat16Li1E",
           "slot": "gemv_kernelILi4E13__nv_bfloat16Li2E",
           "rank_proj": "rank_proj_kernelILi1ELb0E",
           "slot_rank_proj": "rank_proj_kernelILi1ELb1E"}
# name: ({file: {committed text: replacement}}, checked)
DEQ = ("a[jt][hr + 2 * r] = pack_bf16(dq<S>(lo, sc[b], zr[b]),\n"
       "                                        dq<S>(hi, sh[b], zr[b]));")
MMA = ("    mma_bf16(acc[2 * q], a[0], b0, b1);\n"
       "    mma_bf16(acc[2 * q + 1], a[1], b0, b1);")
VARIANTS = {
    "committed": ({}, True),
    # the projection and the GEMV in plain stream order
    "serial": ({"qmatvec.cu": {"constexpr bool kPdl = true;":
                               "constexpr bool kPdl = false;"}}, True),
    # ablations: what one part of the kernel costs
    "no_b_epilogue": ({"qmatvec.cu": {
        "for (; r + 4 <= rank; r += 4)": "for (; r + 4 <= 0; r += 4)",
        "for (; r < rank; ++r)": "for (; r < 0; ++r)"}}, False),
    "no_loop": ({"qmatvec.cu": {
        "for (int s = w_lo; s < w_hi; ++s) {":
        "for (int s = w_lo; s < w_lo; ++s) {"}}, False),
    "no_scale_staging": ({"qmatvec.cu": {
        "  stage_scales<S>(p, scale, zero, ss, zs, grp_lo, ngrp, n0);\n":
        ""}}, False),
    "empty": ({"qmatvec.cu": {
        "  cg::cluster_group cluster = cg::this_cluster();\n":
        "  if (p.m > 0) return;\n  cg::cluster_group cluster = "
        "cg::this_cluster();\n"}}, False),
    # the projection: all r columns, or 16, a block; 128 threads a block
    "proj_full_rank": ({"rank_proj.cuh": {
        "  if (ROWS == 1)\n    for (rc = 8;": "  if (false)\n    for (rc = 8;"}},
        True),
    "proj_rc16": ({"rank_proj.cuh": {
        "for (rc = 8; rank % rc; rc /= 2)": "for (rc = 16; rank % rc; rc /= 2)"}},
        True),
    "proj_128_threads": ({"rank_proj.cuh": {
        "return ROWS == 1 ? 64 : 256;": "return ROWS == 1 ? 128 : 256;"}},
        True),
    # the adapter epilogue and slot mode: one row's B slice only, B from
    # global memory, no epilogue (or only no dot), one shared B slice, no
    # id check
    "slot_b_row0": ({"qmatvec.cu": {
        "const int rows = SLOT ? p.m : 1, rank = p.rank, per = cols / 8;":
        "const int rows = 1, rank = p.rank, per = cols / 8;"}}, False),
    "slot_b_global": ({"qmatvec.cu": {
        "  const size_t bstage = MODE == kBase ? 0 : b_stage_bytes(a, split,":
        "  const size_t bstage = MODE != kAdapter ? 0 : b_stage_bytes(a, split,"
        }}, True),
    "no_epilogue_adapter": ({"qmatvec.cu": {
        "    if (ADAPTER && (!SLOT || sid[i] != 0)) {": "    if (false) {",
        "    if (!ADAPTER) return;": "    return;",
        "    if (ADAPTER && p.bs_off)\n      stage_b":
        "    if (false)\n      stage_b"}}, False),
    "epi_branch_off": ({"qmatvec.cu": {
        "    if (ADAPTER && (!SLOT || sid[i] != 0)) {": "    if (false) {"}},
        False),
    "slot_b_shared": ({"qmatvec.cu": {
        "bs + (SLOT ? i : 0) * rank * cps": "bs + 0 * rank * cps"}}, False),
    "slot_no_trap": ({"qmatvec.cu": {
        "    if (id < 0 || id >= p.n_ad) __trap();\n    sid[tid] = id;":
        "    sid[tid] = id;"}}, False),
    # the projection without its launch_dependents (its end lets the GEMV
    # launch)
    "no_proj_trigger": ({"rank_proj.cuh": {
        '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n':
        ""}}, True),
    "no_dequant": ({"qmatvec.cu": {
        "const float lo = masked_code_f32(v, 0xFu);": "",
        "const float hi = masked_code_f32(v, 0xF0u);": "",
        DEQ: "a[jt][hr + 2 * r] = v;"}}, False),
    "no_mma": ({"qmatvec.cu": {MMA: (
        "    acc[2 * q][0] += __uint_as_float(a[0][0] ^ a[0][1] ^ a[0][2] ^ "
        "a[0][3] ^ b0);\n    acc[2 * q + 1][0] += __uint_as_float(a[1][0] ^ "
        "a[1][1] ^ a[1][2] ^ a[1][3] ^ b1);")}}, False),
    # other splits and depths (checked)
    "blocks1x": ({"qmatvec.cu": {"kBlocksWanted = 132 * 2;":
                                 "kBlocksWanted = 132 * 1;"}}, True),
    "blocks4x": ({"qmatvec.cu": {"kBlocksWanted = 132 * 2;":
                                 "kBlocksWanted = 132 * 4;"}}, True),
    "min_steps8": ({"qmatvec.cu": {"kMinSteps = 4;": "kMinSteps = 8;"}},
                   True),
    "ring_double": ({"qmatvec.cu": {"constexpr int kRingSteps = 4;":
                                    "constexpr int kRingSteps = 8;"}}, True),
}
SOURCES = ("dequant.cuh", "rank_proj.cuh", "qmatvec.cu")
# Appended to every variant's qmatvec.cu: the adapter and slot GEMV alone
# on a given t [m, rank] (bf16; zeros on null rows), in plain stream order.
T_ENTRIES = """
extern "C" int qalora_matvec_t_bf16(const void* x, const void* qw,
                                    const void* scale, const void* zero,
                                    const void* t, const void* B, void* y,
                                    int m, int K, int N, int g, int rank,
                                    float s, int bits, int scale_is_f32,
                                    void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a = gemv_args(x, qw, scale, zero, t, B, nullptr, y, m, K,
                               N, g, rank, 1, s);
  if (!args_ok(a) || rank < 1) return (int)cudaErrorInvalidValue;
  return by_scale<kAdapter>(a, bits, scale_is_f32, false,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int qalora_slot_matvec_t_bf16(const void* x, const void* qw,
                                         const void* scale, const void* zero,
                                         const void* t, const void* B,
                                         const void* ids, void* y, int m,
                                         int K, int N, int g, int rank,
                                         int n_ad, float s, int bits,
                                         int scale_is_f32, void* stream) {
  (void)cudaGetLastError();
  const GemvArgs a = gemv_args(x, qw, scale, zero, t, B, ids, y, m, K, N, g,
                               rank, n_ad, s);
  if (!args_ok(a) || rank < 1 || n_ad < 1) return (int)cudaErrorInvalidValue;
  return by_scale<kSlot>(a, bits, scale_is_f32, false,
                         static_cast<cudaStream_t>(stream));
}
"""
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {**build.SIGNATURES["qmatvec"],
              "qalora_matvec_t_bf16": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 2
                                      + [_P],
              "qalora_slot_matvec_t_bf16": [_P] * 8 + [_I] * 6 + [_F]
                                           + [_I] * 2 + [_P]}
# where the two-launch entries report what they launched (unread here)
_LAUNCHED_BUF = (ctypes.c_int * 2)()
_LAUNCHED = ctypes.addressof(_LAUNCHED_BUF)


def _build(names, root):
    """Compile each variant's qmatvec.cu in parallel; returns {name:
    (library or None, ptxas numbers by entry)}."""
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for f in SOURCES:
            src = (build.CSRC / f).read_text()
            for old, new in VARIANTS[name][0].get(f, {}).items():
                if old not in src:
                    raise ValueError(f"variant {name}: {old!r} not in {f}")
                src = src.replace(old, new)
            if f == "qmatvec.cu":
                src += T_ENTRIES
            with open(os.path.join(d, f), "w") as out:
                out.write(src)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", d,
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "qmatvec.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas = {k: build.ptxas_report(log, e) for k, e in ENTRIES.items()}
        lib = None
        if proc.returncode == 0:
            lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        else:
            ptxas["build_error"] = log[-3000:]
        out[name] = (lib, ptxas)
    return out


class _Case:
    """One linear's operands at one M: weight copies with an adapter bank
    each (A and B rows of every linear cold in L2, as in a model), x, the
    ids, the given t of the ``*_t`` modes, and the scratch and outputs."""

    def __init__(self, gen, m, k, n):
        self.m, self.k, self.n = m, k, n
        per_copy = k * n // 2 + 4 * (k // GROUP) * n
        self.qts = [quant.quantize(
            torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k),
            4, GROUP, scale_dtype=torch.bfloat16)
            for _ in range(max(2, math.ceil(2.5 * 50e6 / per_copy)))]
        self.x = torch.randn((m, k), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        self.banks = [self._bank(gen, k, n) for _ in self.qts]
        self.ids = torch.tensor(SLOT_IDS[m], dtype=torch.int32, device="cuda")
        self.ids_one = torch.ones((m,), dtype=torch.int32, device="cuda")
        self.ids_null = torch.zeros((m,), dtype=torch.int32, device="cuda")
        self.t = torch.empty((m, RANK), dtype=torch.bfloat16, device="cuda")
        self.t_given = [qalora_rank_proj_plain(self.x, ab[1], group_size=GROUP)
                        for ab, _ in self.banks]
        self.slot_t_given = [qalora_slot_rank_proj_plain(
            self.x, ab, self.ids, group_size=GROUP) for ab, _ in self.banks]
        self.y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        self.dense = [quant.dequantize(q, torch.bfloat16)
                      for q in self.qts[:max(2, math.ceil(
                          2.5 * 50e6 / (2 * k * n)))]]

    @staticmethod
    def _bank(gen, k, n):
        """A BANK_ROWS-row adapter bank; row 0 the null adapter, row 1 the
        adapter of the single-adapter modes."""
        ab = (torch.randn((BANK_ROWS, k // GROUP, RANK), generator=gen,
                          device="cuda") / math.sqrt(k // GROUP) + 0.01) \
            .to(torch.bfloat16)
        bb = (torch.randn((BANK_ROWS, RANK, n), generator=gen, device="cuda")
              * 0.01 + 0.01).to(torch.bfloat16)
        ab[0] = 0
        bb[0] = 0
        return ab, bb

    @staticmethod
    def _w(qt):
        return qt.qweight, qt.scale, qt.zero

    def call(self, lib, mode, j):
        """One launch of ``mode`` on weight copy ``j`` and its adapter bank
        (no sync)."""
        st = torch.cuda.current_stream().cuda_stream
        p = lambda t: t.data_ptr()  # noqa: E731
        qt, (ab, bb) = self.qts[j], self.banks[j]
        w = (p(qt.qweight), p(qt.scale), p(qt.zero))
        m, k, n = self.m, self.k, self.n
        if mode == "base":
            rc = lib.qmatvec_bf16(p(self.x), *w, p(self.y), m, k, n, GROUP, 4,
                                  0, st)
        elif mode == "adapter":
            rc = lib.qalora_matvec_bf16(
                p(self.x), *w, p(ab[1]), p(bb[1]), p(self.t), p(self.y), m,
                k, n, GROUP, RANK, S_ADAPTER, 4, 0, _LAUNCHED, st)
        elif mode == "proj":
            rc = lib.qalora_gemv_rank_proj_bf16(p(self.x), p(ab[1]), p(self.t),
                                                m, k, GROUP, RANK, st)
        elif mode == "slot_proj":
            rc = lib.qalora_slot_rank_proj_bf16(
                p(self.x), p(ab), p(self.ids), p(self.t), m, k, GROUP, RANK,
                BANK_ROWS, st)
        elif mode in ("slot_t", "slot_t_null"):
            ids = self.ids_null if mode == "slot_t_null" else self.ids
            rc = lib.qalora_slot_matvec_t_bf16(
                p(self.x), *w, p(self.slot_t_given[j]), p(bb), p(ids),
                p(self.y), m, k, n, GROUP, RANK, BANK_ROWS, S_ADAPTER, 4, 0,
                st)
        elif mode == "adapter_t":
            rc = lib.qalora_matvec_t_bf16(
                p(self.x), *w, p(self.t_given[j]), p(bb[1]), p(self.y), m, k,
                n, GROUP, RANK, S_ADAPTER, 4, 0, st)
        else:
            ids = {"slot_one": self.ids_one,
                   "slot_null": self.ids_null}.get(mode, self.ids)
            rc = lib.qalora_slot_matvec_bf16(
                p(self.x), *w, p(ab), p(bb), p(ids), p(self.t), p(self.y), m,
                k, n, GROUP, RANK, BANK_ROWS, S_ADAPTER, 4, 0, _LAUNCHED,
                st)
        build.check(rc, f"gemv variant {mode}")
        return self.t if mode.endswith("proj") else self.y

    def plain(self, mode):
        """The plain version of ``mode`` on copy 0."""
        qt, (ab, bb) = self.qts[0], self.banks[0]
        kw = dict(bits=4, group_size=GROUP)
        if mode == "proj":
            return qalora_rank_proj_plain(self.x, ab[1], group_size=GROUP)
        if mode == "slot_proj":
            return qalora_slot_rank_proj_plain(self.x, ab, self.ids,
                                               group_size=GROUP)
        if mode == "base":
            return qmatvec_plain(self.x, *self._w(qt), **kw)
        if mode.startswith("adapter"):
            return qalora_matvec_plain(self.x, *self._w(qt), ab[1], bb[1],
                                       s=S_ADAPTER, **kw)
        ids = {"slot_one": self.ids_one, "slot_null": self.ids_null,
               "slot_t_null": self.ids_null}.get(mode, self.ids)
        return qalora_slot_matvec_plain(self.x, *self._w(qt), ab, bb, ids,
                                        s=S_ADAPTER, **kw)


def time_graph_ms(fn, arg_sets, iters=ITERS):
    """Device time of one call: ``iters`` calls rotating through
    ``arg_sets`` captured in one CUDA graph, one replay timed with CUDA
    events."""
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


def _err_over_tol(y, ref):
    y, ref = y.float(), ref.float()
    return (y - ref).abs().max().item() / (2.0 ** -6 * ref.abs().max().item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--modes", default="base,adapter,slot",
                    help=f"any of {','.join(MODES)}")
    ap.add_argument("--m", default="1,4,8")
    ap.add_argument("--out", default="chiprun_out/gemv_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemv_variants needs an NVIDIA card")
    names, modes = args.variants.split(","), args.modes.split(",")
    ms = [int(v) for v in args.m.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    built = _build(names, str(build.build_dir() / "gemv_variants"))
    for name, (_, ptxas) in built.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {(m, k, n): _Case(gen, m, k, n) for m in ms for k, n, _ in SHAPES}
    rows = []
    for rnd in range(ROUNDS):
        lib_row = {"variant": "library (cuBLAS, pre-dequantised weight)",
                   "round": rnd}
        for m in ms:
            lib_row[f"M{m}_layer_ms"] = sum(
                count * time_graph_ms(
                    lambda w, c=cases[(m, k, n)]: c.x @ w,
                    [(w,) for w in cases[(m, k, n)].dense])
                for k, n, count in SHAPES)
        rows.append(lib_row)
        print(json.dumps(lib_row), flush=True)
        for name, (lib, _) in built.items():
            if lib is None:
                continue
            for mode in modes:
                row = {"variant": name, "mode": mode, "round": rnd}
                for m in ms:
                    layer = 0.0
                    for k, n, count in SHAPES:
                        c = cases[(m, k, n)]
                        if rnd == 0 and VARIANTS[name][1]:
                            y = c.call(lib, mode, 0).clone()
                            row[f"M{m}_err_over_tol_{k}x{n}"] = \
                                _err_over_tol(y, c.plain(mode))
                        ms_ = time_graph_ms(
                            lambda j, c=c: c.call(lib, mode, j),
                            [(j,) for j in range(len(c.qts))])
                        row[f"M{m}_ms_{k}x{n}"] = ms_
                        layer += count * ms_
                    row[f"M{m}_layer_ms"] = layer
                rows.append(row)
                print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card,
                   "ptxas": {n: p for n, (_, p) in built.items()},
                   "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
