"""Logical-axis sharding rules and the tensor-parallel collectives of the
port (``rules``: pure Python; ``tp``: ``torch.autograd.Function``s over
the mesh's process groups)."""
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    SERVE_RULES,
    TRAIN_DP_RULES,
    PartitionSpec,
    ShardingContext,
    current_context,
    explain_pspec,
    no_sharding,
    resolve_pspec,
    rules_for,
    use_sharding,
)

__all__ = [
    "DEFAULT_RULES",
    "SERVE_RULES",
    "TRAIN_DP_RULES",
    "PartitionSpec",
    "ShardingContext",
    "current_context",
    "explain_pspec",
    "no_sharding",
    "resolve_pspec",
    "rules_for",
    "use_sharding",
]
