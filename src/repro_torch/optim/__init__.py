"""Optimizer: AdamW, schedules, clipping and gradient compression."""

from repro_torch.optim.adamw import (
    AdamWState,
    CompressionState,
    OptimizerConfig,
    apply_updates,
    clip_by_global_norm,
    compress_decompress,
    global_norm,
    init_compression,
    init_state,
    schedule_lr,
)

__all__ = [
    "AdamWState",
    "CompressionState",
    "OptimizerConfig",
    "apply_updates",
    "clip_by_global_norm",
    "compress_decompress",
    "global_norm",
    "init_compression",
    "init_state",
    "schedule_lr",
]
