from repro_torch.sharding.partitioning import (
    FULL_DP_RULES,
    MULTI_POD_RULES,
    NO_KV_SHARD_RULES,
    RULE_SETS,
    SINGLE_POD_RULES,
    axis_rules,
    mesh_axis_size,
    named_sharding,
    resolve,
    rule_set,
    shard,
)
from repro_torch.sharding.tp import (
    tp_active,
    tp_all_gather,
    tp_check_cfg,
    tp_context,
    tp_local_cfg,
    tp_param_specs,
    tp_size,
)

__all__ = [
    "FULL_DP_RULES", "MULTI_POD_RULES", "NO_KV_SHARD_RULES",
    "RULE_SETS", "SINGLE_POD_RULES", "axis_rules", "mesh_axis_size",
    "named_sharding", "resolve", "rule_set", "shard",
    "tp_active", "tp_all_gather", "tp_check_cfg", "tp_context",
    "tp_local_cfg", "tp_param_specs", "tp_size",
]
