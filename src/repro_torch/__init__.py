"""PyTorch + CUDA port of the QA-LoRA reproduction (``src/repro`` is the
JAX reference).  Serves the merged INT-N gqa model on an NVIDIA Hopper card
through hand-written dequant-matmul kernels (``csrc/``); every entry point
runs on CUDA unless the caller asks for ``device="cpu"``."""
