"""One production cell per family built as one rank's program of the
16x16 pod mesh and counted on the ``meta`` device, with no device and no
other process: a taste of the port's full dry run (see
``repro_torch.launch.dryrun``).

    PYTHONPATH=src python examples/multiarch_dryrun_torch.py
"""

from repro_torch.launch.dryrun import run_cell

for arch, cell in [
    ("gemma3-1b", "decode_32k"),        # dense GQA, sliding-window
    ("rwkv6-7b", "long_500k"),          # attention-free, 500k context
    ("deepseek-v3-671b", "decode_32k"),  # MLA + 256-expert MoE
]:
    rec = run_cell(arch, cell, "pod", outdir="build/dryrun_example",
                   force=True)
    if rec["ok"]:
        print(f"{arch:20s} {cell:12s} flops/rank={rec['cost']['flops']:.2e} "
              f"held={rec['memory']['total_bytes'] / 2**30:.2f}GiB "
              f"{rec['seconds']:.1f}s")
    else:
        print(f"{arch:20s} {cell:12s} refused: {rec['reason']}")
print("every example cell recorded as one rank of the 256-process production "
      "mesh: ok with its counted step, or refused with the reason")
