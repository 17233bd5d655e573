"""Quantization, the QA-LoRA adapter, the baselines (LoRA, QLoRA / NF4,
GPTQ) and the linear-scheme registry."""

from .quant import (QuantizedLinear, dequantize, pack,  # noqa: F401
                    quantization_error, quantize, unpack)
from .qalora import (QALoRAParams, adapter_delta, attach,  # noqa: F401
                     group_pool, init_qalora, merge, qalora_forward)
from .lora import (LoRAParams, init_lora, lora_forward,  # noqa: F401
                   lora_merge, qlora_forward, qlora_merge_fp,
                   qlora_merge_ptq, qlora_quantize_base)
from .gptq import (gptq_quantize,  # noqa: F401
                   gptq_quantize_from_calibration, hessian_from_inputs)
from .nf4 import NF4Tensor, nf4_dequantize, nf4_quantize  # noqa: F401
from .convert import convert_tree  # noqa: F401
from .schemes import (FP, LinearParams, LinearScheme,  # noqa: F401
                      PolicyTree, QuantPolicy, dense_linear, dense_view,
                      from_dense_linear, get_scheme, is_linear,
                      linear_apply, linear_init, map_linears, merge_linear,
                      merge_tree, register_scheme, resolve_path,
                      trainable_tensors)
