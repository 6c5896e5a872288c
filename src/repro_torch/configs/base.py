"""Execution-policy configuration.

``CIMPolicy`` says where and how the paper's macro executes a model's
weight matmuls: the execution mode, the macro operating point and the
per-call knobs. The LM model configurations come with slice 3 of
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.params import CIMConfig


@dataclasses.dataclass(frozen=True)
class CIMPolicy:
    """Where/how the paper's macro executes a model's weight matmuls.

    Consumed by the plan/execute engine (core.engine),
    models/common.linear_apply and models/resnet. Frozen and hashable.
    """

    mode: str = "fp"  # 'fp' | 'cim-exact' | 'cim' | 'cim-kernel'
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    # Execution backend key in core.engine's registry; '' derives the
    # backend from `mode` (the mode strings are registered aliases).
    backend: str = ""
    # Straight-through gradients through the macro forward (QAT); read by
    # the training path (ROADMAP slice 6).
    ste: bool = True
    # Which matmul families run through the macro.
    apply_to_attn_proj: bool = True
    apply_to_mlp: bool = True
    apply_to_experts: bool = True
    apply_to_logits: bool = False  # vocab matmul usually stays digital
    act_symmetric: bool = False  # True for post-ReLU (the paper's CNNs)
    # Percentile-clipped activation calibration (1.0 = plain min/max).
    act_clip_pct: float = 1.0
    # First (stem) conv sees raw signed inputs; production CIM CNNs keep
    # it digital (standard first/last-layer exemption).
    apply_to_stem: bool = False
