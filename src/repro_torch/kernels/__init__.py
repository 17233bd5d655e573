"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, behind the dispatching entry points of :mod:`.ops`.

``KERNELS`` maps each kernel's name to its wrapper; every wrapper carries a
plain-integer ``launches`` count that it raises by one per kernel launch
(CPU calls, which take the plain version, do not count).  A replayed CUDA
graph runs no wrapper: :class:`repro_torch.runtime.graphs.StepGraphs`
takes the counts a capture raised back off (:func:`add_launches` with
the negated delta) and adds them again on every replay.
"""

from __future__ import annotations

from .flash import flash_mha_cuda
from .qalora_fused import qalora_matmul_cuda, qalora_rank_proj_cuda
from .qmatmul import qmatmul_cuda
from .qmatvec import (GEMV_MAX_M, qalora_matvec_cuda,
                      qalora_slot_matvec_cuda, qalora_slot_rank_proj_cuda,
                      qmatvec_cuda)

KERNELS = {
    "qmatmul": qmatmul_cuda,
    "qmatvec": qmatvec_cuda,
    "qalora_matmul": qalora_matmul_cuda,
    # the rank projection, the first launch of kernels 3 and 4, counted
    # apart
    "qalora_rank_proj": qalora_rank_proj_cuda,
    "qalora_matvec": qalora_matvec_cuda,
    # kernel 5's first launch (the slot projection), counted apart
    "qalora_slot_rank_proj": qalora_slot_rank_proj_cuda,
    "qalora_slot_matvec": qalora_slot_matvec_cuda,
    "flash_mha": flash_mha_cuda,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launches(delta: dict) -> None:
    """Add ``delta`` ({name: count}) to the kernels' launch counts."""
    for name, n in delta.items():
        KERNELS[name].launches += n


__all__ = ["GEMV_MAX_M", "KERNELS", "add_launches", "launches",
           "reset_launches",
           "qmatmul_cuda", "qmatvec_cuda", "qalora_matmul_cuda",
           "qalora_rank_proj_cuda", "qalora_slot_rank_proj_cuda",
           "qalora_matvec_cuda", "qalora_slot_matvec_cuda", "flash_mha_cuda"]
