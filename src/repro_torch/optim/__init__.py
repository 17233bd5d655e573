from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,  # noqa: F401
                    clip_by_global_norm, constant_schedule, cosine_schedule,
                    warmup_cosine)
from .partition import trainable_tensors, split_params, count_params  # noqa: F401
