"""Quantization, the QA-LoRA adapter and the linear-scheme registry."""
