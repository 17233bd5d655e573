"""The roofline machinery (counterpart of ``repro.perf``): the per-step
cost counter (:mod:`.cost`) and the roofline terms of a step on the H100
(:mod:`.roofline`)."""

from .cost import CostCounter, OpCost  # noqa: F401
from .roofline import HW, active_params, model_flops, roofline_terms  # noqa: F401
