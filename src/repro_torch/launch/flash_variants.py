"""Variants of flash attention (kernel 6, ``csrc/flash.cu``) side by side
with PyTorch's ``scaled_dot_product_attention`` backends, on one card.

    python -m repro_torch.launch.flash_variants
    python -m repro_torch.launch.flash_variants --variants committed --rounds 2

Each variant is the committed source with a few lines replaced (none for
``committed``), built into its own library.  Every variant meant to be
right is held, once per row, against :func:`flash_mha_plain` on the card
with the row-wise bound of ``chip_smoke.py`` (per query row, max|y - ref|
within 2**-6 of that row's max|ref|: ``row_err_ratio`` <= 1).  Each SDPA
backend (``SDPA_BACKENDS``) is forced in turn with
``torch.nn.attention.sdpa_kernel``; one that refuses the inputs is
recorded with its error and skipped, and the fastest that ran is the
library time.  ``sdpa_default`` is the call without a forced backend, as
``chip_smoke.py`` times it.

The rows are ``chip_smoke.py``'s ``FLASH_ROWS`` (bf16, causal): kernel
and library calls are timed with CUDA events over ``ITERS`` calls that
rotate over two input copies (L2 cold), in ``--rounds`` rounds, the order
of the callees reversed every other round.  Prints the card, each
variant's ptxas registers and spills (every flash instantiation the
build reports; with ``--sass`` also each wgmma instantiation's highest
register, wgmma count, waits on wgmma and local loads and stores, read
with ``cuobjdump``), one JSON line per row and round, and a summary of
min-max per callee and row; writes all of it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import torch

from ..kernels import build
from ..kernels.flash import DESIGNS, flash_mha_plain

# chip_smoke.py's FLASH_ROWS: (row, B, S, heads, KV heads, head dim, window)
ROWS = (("llama7b-proxy", 4, 2048, 32, 32, 128, 0),
        ("gemma3-1b local", 4, 4096, 4, 1, 256, 512),
        ("gemma3-1b global", 4, 4096, 4, 1, 256, 0))
ROW_TOL = 2.0 ** -6
ROUNDS = 3
ITERS = 20
# H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# the spin of sm90::mbar_wait with a bound that traps
TRAP_SPIN = ("  uint32_t done = 0;\n  do {",
             "  uint32_t done = 0, tries = 0;\n  do {\n"
             "    if (++tries == (1u << 26)) __trap();")
# name: ({committed text of flash.cu: replacement}, checked against the
# plain version); a replacement in another source of csrc/ sits under that
# file's name
VARIANTS = {
    "committed": ({}, True),
    # the first port's mma.sync kernel for every bf16 head dim
    "mma_sync": ({"constexpr int kWgmmaMinD = 64;":
              "constexpr int kWgmmaMinD = 512;"}, True),
    # ablations of the new design, each still right
    "ring1": ({"constexpr int kRing = 2;": "constexpr int kRing = 1;"}, True),
    # a deeper ring where shared memory allows (d <= 128)
    "ring3": ({"constexpr int kRing = 2;": "constexpr int kRing = 3;"}, True),
    "no_pingpong": ({"constexpr bool kPingPong = true;":
                     "constexpr bool kPingPong = false;"}, True),
    # K and V of the same tile loaded together (no K ahead of V)
    "kv_together": ({"constexpr bool kKAhead = true;":
                     "constexpr bool kKAhead = false;"}, True),
    # O stored straight from registers (no TMA store)
    "direct_store": ({"constexpr bool kTmaStore = true;":
                      "constexpr bool kTmaStore = false;"}, True),
    # block order: every batch-head in one group, the first port's order
    # (query tile slowest, batch-head fastest; windowed calls too), and
    # groups of 3 or 12 blocks a batch-head in a wave
    "one_group": ({"  a.group = a.window > 0 ? 1\n":
                   "  a.group = a.window > 0 ? a.bh\n",
                   "constexpr int kWaveBlocksPerHead = 6;":
                   "constexpr int kWaveBlocksPerHead = 1;"}, True),
    "wave_blocks_3": ({"constexpr int kWaveBlocksPerHead = 6;":
                       "constexpr int kWaveBlocksPerHead = 3;"}, True),
    "wave_blocks_12": ({"constexpr int kWaveBlocksPerHead = 6;":
                        "constexpr int kWaveBlocksPerHead = 12;"}, True),
    # a bound on every mbarrier spin that traps: ptxas then ignores the
    # setmaxnreg budgets, spills and serialises the wgmma
    "trap_in_waits": ({"sm90.cuh": dict([TRAP_SPIN])}, True),
    # softmax waits for the previous tile's P V too (no overlap inside a
    # warpgroup)
    "no_intra_overlap": ({"sm90::wgmma_wait<1>();  // Q K^T done":
                          "sm90::wgmma_wait<0>();  // Q K^T done"}, True),
}


def visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask keeps, per batch-head."""
    total = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(sk - 1, i) if causal else sk - 1
        total += max(hi - lo + 1, 0)
    return total


def bound(bh, sq, sk, d, causal, window):
    """4 d flops per visible pair (q k^T and p v) over the bf16 peak, or q,
    k, v read once and o written once (bf16) over the memory rate: the
    larger, and which it is."""
    flops = 4 * d * bh * visible_pairs(sq, sk, causal, window)
    nbytes = (2 * sq + 2 * sk) * bh * d * 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_ptxas(log):
    """{kernel entry: registers, stack and spills} of every flash kernel in
    an ``nvcc -Xptxas -v`` log."""
    import re
    out = {}
    for block in log.split("Compiling entry")[1:]:
        m = re.search(r"'([^']+)'", block.splitlines()[0])
        if m and "flash" in m.group(1):
            out[m.group(1)] = build.ptxas_report(log, m.group(1))
    return out


def sass_stats(lib):
    """Per wgmma instantiation of a built library (by head dim): the
    highest register its SASS names, and its counts of wgmma (HGMMA),
    waits on them (WARPGROUP.DEPBAR: one per HGMMA means ptxas serialised
    them) and local-memory loads and stores (spills)."""
    import collections
    import re
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    stats = {}
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        m = re.search(r"flash_wgmmaILi(\d+)E", fn.splitlines()[0])
        if not m:
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
        stats[int(m.group(1))] = {
            "max_register": max(int(r) for r in re.findall(r"\bR(\d+)\b",
                                                          fn)),
            **{key: sum(v for op, v in ops.items() if op.startswith(pre))
               for key, pre in (("hgmma", "HGMMA"),
                                ("wgmma_waits", "WARPGROUP.DEPBAR"),
                                ("local_loads", "LDL"),
                                ("local_stores", "STL"))}}
    return stats


def patched_sources(name):
    """{file: text} of flash.cu and the headers of csrc/ for one variant,
    its replacements applied (each must find its text)."""
    sources = {f.name: f.read_text()
               for f in [*build.CSRC.glob("*.cuh"), build.CSRC / "flash.cu"]}
    for key, val in VARIANTS[name][0].items():
        file, repl = (key, val) if isinstance(val, dict) else \
            ("flash.cu", {key: val})
        for old, new in repl.items():
            if old not in sources[file]:
                raise ValueError(f"variant {name}: {old!r} not in {file}")
            sources[file] = sources[file].replace(old, new)
    return sources


def _build(names, root):
    """Compile each variant's flash.cu in parallel; returns {name: (entry
    or None, ptxas report)}."""
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for f, src in patched_sources(name).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(src)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", d,
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "flash.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        report = {"kernels": flash_ptxas(log)}
        warn = [ln for ln in log.splitlines()
                if "arning" in ln or "Performance Loss" in ln]
        if warn:
            report["warnings"] = warn[:20]
        fn = None
        if proc.returncode == 0:
            fn = ctypes.CDLL(os.path.join(root, name, "lib.so")).flash_mha_fwd
            fn.argtypes = build.SIGNATURES["flash"]["flash_mha_fwd"]
            fn.restype = ctypes.c_int
        else:
            report["build_error"] = log[-3000:]
        out[name] = (fn, report)
    return out


def _call(fn, q, k, v, o, window, design):
    bh, sq, d = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            k.shape[1], d, 1, window, 1.0 / math.sqrt(d), 0,
            ctypes.byref(design), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_mha_fwd (variant)")


def _inputs(gen, b, s, h, kvh, d):
    """q, k, v folded to [B*H, S, d] bf16; K and V of kvh heads repeated to
    h on the head axis, as chip_smoke.py makes them."""
    def rnd(heads):
        return torch.randn((b, s, heads, d), generator=gen, device="cuda") \
            .to(torch.bfloat16)
    q, k, v = rnd(h), rnd(kvh), rnd(kvh)
    if kvh < h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    return [t.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()
            for t in (q, k, v)]


def _time_ms(fn, arg_sets, iters=ITERS):
    """CUDA-event time of one call over ``iters`` calls rotating over
    ``arg_sets`` (two input copies: the L2 stays cold)."""
    for args in arg_sets:
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


def row_ratio(y, ref):
    """Largest max|y - ref| of a query row over ROW_TOL times that row's
    max|ref|: at most 1 passes."""
    yf, rf = y.float(), ref.float()
    return ((yf - rf).abs().amax(-1)
            / (ROW_TOL * rf.abs().amax(-1))).max().item()


def sdpa_call(s, window, backend):
    """One SDPA call on [B, H, S, d]: causal, or a boolean band for the
    window; forced to ``backend`` unless it is None."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if window:
        i = torch.arange(s, device="cuda")[:, None]
        j = torch.arange(s, device="cuda")[None, :]
        band = (j <= i) & (j > i - window)
        kw = {"attn_mask": band}
    else:
        kw = {"is_causal": True}

    def call(q, k, v):
        ctx = (sdpa_kernel([getattr(SDPBackend, backend)]) if backend
               else contextlib.nullcontext())
        with ctx:
            return F.scaled_dot_product_attention(q, k, v, **kw)
    return call


def _callees(built, row, copies):
    """{callee: (fn over one copy, checked)} for one row: each built
    variant, each SDPA backend that takes the inputs, SDPA's default."""
    name, b, s, h, _, d, window = row
    out, refused = {}, {}
    for var, (fn, _) in built.items():
        if fn is None:
            continue
        o = torch.empty_like(copies[0][0])
        design = ctypes.c_int(-1)

        def run(q, k, v, fn=fn, o=o, design=design):
            _call(fn, q, k, v, o, window, design)
            return o, design
        out[var] = (run, VARIANTS[var][1])
    for backend in (None, *SDPA_BACKENDS):
        call = sdpa_call(s, window, backend)
        key = f"sdpa_{(backend or 'default').lower()}"

        def run(q, k, v, call=call):
            return call(*(t.view(b, h, s, d) for t in (q, k, v))) \
                .reshape(b * h, s, d), None
        try:
            run(*copies[0])
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused[key] = str(e).strip().splitlines()[0][:300]
            continue
        out[key] = (run, True)
    return out, refused


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rows", default=",".join(r[0] for r in ROWS))
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--sass", action="store_true",
                    help="add each variant's SASS counts (cuobjdump)")
    ap.add_argument("--out", default="chiprun_out/flash_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants needs an NVIDIA card: "
                         "torch.cuda.is_available() is False")
    names = args.variants.split(",")
    rows = [r for r in ROWS if r[0] in args.rows.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    root = str(build.build_dir() / "flash_variants")
    built = _build(names, root)
    for name, (fn, report) in built.items():
        if args.sass and fn is not None:
            report["sass"] = sass_stats(os.path.join(root, name, "lib.so"))
        print(json.dumps({"variant": name, "ptxas": report}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "ptxas": {n: r for n, (_, r) in built.items()}, "rows": {},
              "times": []}
    for row in rows:
        name, b, s, h, kvh, d, window = row
        copies = [_inputs(gen, b, s, h, kvh, d) for _ in range(2)]
        callees, refused = _callees(built, row, copies)
        ref = flash_mha_plain(*copies[0], causal=True, window=window)
        checks = {}
        for callee, (run, checked) in callees.items():
            y, design = run(*copies[0])
            torch.cuda.synchronize()
            checks[callee] = {
                "row_err_ratio": row_ratio(y, ref) if checked else None,
                "design": DESIGNS.get(design.value, design.value)
                if design is not None else None}
        del ref
        info = {"B": b, "S": s, "H": h, "KvH": kvh, "d": d, "window": window,
                **bound(b * h, s, s, d, True, window), "checks": checks,
                "sdpa_refused": refused}
        record["rows"][name] = info
        print(json.dumps({"row": name, **info}), flush=True)
        for rnd in range(args.rounds):
            order = list(callees) if rnd % 2 == 0 else list(callees)[::-1]
            times = {c: _time_ms(callees[c][0], copies) for c in order}
            entry = {"row": name, "round": rnd, "ms": times}
            record["times"].append(entry)
            print(json.dumps(entry), flush=True)
        del copies, callees
        torch.cuda.empty_cache()
    record["summary"] = summarize(record)
    for line in record["summary"]:
        print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


def summarize(record):
    """Per row and callee: min and max ms over the rounds, and the min over
    the fastest SDPA backend's min and over the bound."""
    out = []
    for name, info in record["rows"].items():
        times = [t["ms"] for t in record["times"] if t["row"] == name]
        span = {c: (min(t[c] for t in times), max(t[c] for t in times))
                for c in times[0]}
        forced = {c: v for c, v in span.items()
                  if c.startswith("sdpa_") and c != "sdpa_default"}
        fastest = min(forced, key=lambda c: forced[c][0]) if forced else None
        lib = forced[fastest][0] if fastest else None
        out.append({"row": name, "fastest_sdpa": fastest, "library_ms": lib,
                    "bound_ms": info["bound_ms"], "ms": span,
                    "over_library": {c: v[0] / lib for c, v in span.items()}
                    if lib else None,
                    "over_bound": {c: v[0] / info["bound_ms"]
                                   for c, v in span.items()}})
    return out


if __name__ == "__main__":
    main()
