"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for sm_90a
into its own shared library with a plain C interface and loaded with
``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
Libraries are cached by the hash of their sources in the build directory
(``$REPRO_TORCH_BUILD_DIR``, default ``build/repro_torch`` at the root of
the checkout).  :func:`build_all` starts one ``nvcc`` per source, all at
once.

Every C entry returns ``cudaGetLastError()`` after its launch; the Python
wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("qmatmul", "qmatvec", "qalora_fused", "flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry, by library
SIGNATURES = {
    "qmatmul": {"qmatmul_bf16": [_P] * 5 + [_I] * 7 + [_P],
                "tiled_design": [_I] * 5 + [_P]},
    "qmatvec": {
        "qmatvec_bf16": [_P] * 5 + [_I] * 6 + [_P],
        "qalora_matvec_bf16": [_P] * 8 + [_I] * 5 + [_F] + [_I] * 2
                              + [_P] * 2,
        "qalora_gemv_rank_proj_bf16": [_P] * 3 + [_I] * 4 + [_P],
        "qalora_slot_rank_proj_bf16": [_P] * 4 + [_I] * 5 + [_P],
        "qalora_slot_matvec_bf16": [_P] * 9 + [_I] * 6 + [_F] + [_I] * 2
                                   + [_P] * 2,
    },
    "qalora_fused": {
        "qalora_rank_proj_bf16": [_P] * 3 + [_I] * 4 + [_P],
        "qalora_matmul_bf16": [_P] * 7 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    },
    "flash": {"flash_mha_fwd": [_P] * 4 + [_I] * 6 + [_F, _I, _P, _P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# the ptxas report of each build (registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "CUDA kernels are built on the machine with the card")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_source_hash(name)}.so"


def _nvcc_cmd(name: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: seconds} of the builds that ran."""
    import time
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(_nvcc_cmd(n, tmp),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    secs, errors = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, _lib_path(n))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def ptxas_report(log: str, entry: str) -> Optional[dict]:
    """Registers, stack frame and spill bytes of the kernel whose mangled
    name contains ``entry``, read from an ``nvcc -Xptxas -v`` log (such as
    ``BUILD_LOG[name]``); None if the log has no such kernel."""
    import re
    for block in log.split("Compiling entry")[1:]:
        if entry in block.splitlines()[0]:
            return {key: int(m.group(1)) if (m := re.search(pat, block))
                    else None
                    for key, pat in (("registers", r"Used (\d+) registers"),
                                     ("stack", r"(\d+) bytes stack frame"),
                                     ("spill_stores",
                                      r"(\d+) bytes spill stores"),
                                     ("spill_loads",
                                      r"(\d+) bytes spill loads"))}
    return None


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} (cudaError_t)")


def current_stream(device: Optional[object] = None) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
