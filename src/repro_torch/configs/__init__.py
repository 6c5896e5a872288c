"""Arch registry: one module per architecture (``get_config``), each
with CONFIG (published dims) and SMOKE (a reduced config of the same
family); the paper's ResNet is ``configs.resnet``."""

from repro_torch.configs.base import (
    ARCH_IDS,
    FULL_ATTENTION_ARCHS,
    SHAPES,
    CIMPolicy,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    get_config,
    shape_cells,
)

__all__ = [
    "ARCH_IDS",
    "FULL_ATTENTION_ARCHS",
    "SHAPES",
    "CIMPolicy",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "RWKVConfig",
    "ShapeConfig",
    "get_config",
    "shape_cells",
]
