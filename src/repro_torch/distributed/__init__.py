"""Distribution: logical-axis sharding rules + activation constraints."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    batch_axes,
    cache_axes,
    constrain,
    constrain_query,
    replicated,
    sharding_for,
    spec_for,
    tree_shardings,
)

__all__ = [
    "DEFAULT_RULES",
    "batch_axes",
    "cache_axes",
    "constrain",
    "constrain_query",
    "replicated",
    "sharding_for",
    "spec_for",
    "tree_shardings",
]
