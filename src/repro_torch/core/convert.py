"""Checkpoint conversion: a float model -> QA-LoRA (or any scheme).

The paper's workflow: start from a pretrained float LLM, quantize its base
(RTN, or GPTQ through ``quantizer=``), attach fresh adapters, fine-tune.
The walk is :func:`repro_torch.core.schemes.convert_tree`: every linear's
effective dense weight is re-stored under the target policy's scheme, so
conversion works between any registered pair, per-layer
:class:`~repro_torch.core.schemes.PolicyTree` targets included.
"""

from __future__ import annotations

from .schemes import convert_tree  # noqa: F401
