"""Partition specs (counterpart of ``repro.sharding``) and this rank's
shard of a params tree."""

from .rules import (TP_AXIS, DP_AXES, COL, ROW, padded, spec_axes,  # noqa: F401
                    spec_for_param, param_specs, expert_split,
                    holds_expert, rank_param_bytes,
                    batch_spec_tree,
                    cache_spec_tree)
from .shard import (Mode, LinearTP, ExpertShard, ShardSpecs,  # noqa: F401
                    shard_tensor, gather_tensor,
                    shard_tensors, gather_tensors, shard_params,
                    gather_params, tp_of, DecodeLayout, decode_layout,
                    cache_part, gather_cache, check_cache_part)
