from repro_torch.sharding.logical import (
    LogicalRules,
    TRAIN_RULES,
    SERVE_RULES,
    resolve_spec,
    logical_constraint,
    use_rules,
    current_rules,
)
from repro_torch.sharding.partition import (
    param_shardings,
    shape_shardings,
    tree_size_bytes,
)

__all__ = [
    "LogicalRules",
    "TRAIN_RULES",
    "SERVE_RULES",
    "resolve_spec",
    "logical_constraint",
    "use_rules",
    "current_rules",
    "param_shardings",
    "shape_shardings",
    "tree_size_bytes",
]
