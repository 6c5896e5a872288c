"""Weight-only int8 serving as a PlannedWeights representation.

The paper's macro stores 8-bit weights resident in SRAM; the digital
analogue is W8A16 weight-only quantization: weights live in device
memory as int8 codes plus per-output-channel scales and are dequantized
into the matmul's operand on the fly. Decode is weight-traffic-bound, so
int8 storage cuts the memory term about 4x against f32. This module is a
thin serving-flavored wrapper over ``core.engine.plan_params``;
``common.linear_apply`` dispatches on the PlannedWeights type.
The older ``{'w_q', 'w_s'}`` dict leaves are read too. Embeddings and
norms stay high precision.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import engine
from repro_torch.core.engine import PlannedWeights


def dequantize_weight(q, dtype) -> torch.Tensor:
    """Read path for a planned int8 weight, or for the JAX package's
    older ``{'w_q', 'w_s'}`` dict leaves (codes and per-channel scales,
    as old checkpoints hold them): ``w_q * w_s`` in ``dtype``."""
    if isinstance(q, PlannedWeights):
        return q.dequantized(dtype)
    return q["w_q"].to(dtype) * q["w_s"].to(dtype)


def maybe_dequant(w, dtype) -> torch.Tensor:
    """Pass-through for plain tensors; dequantize the int8 serving form.
    PlannedWeights that kept their float weights (CIM plans) read those
    back exactly. For modules that index weight leaves directly (the MoE
    expert banks, mamba's x_proj and dt_proj)."""
    if isinstance(w, PlannedWeights):
        return w.best_weights(dtype)
    if isinstance(w, dict):
        return dequantize_weight(w, dtype)
    return w.to(dtype)


def quantize_params_for_serving(params: Any) -> Any:
    """Rewrite matmul weights to int8 PlannedWeights (no float copy, no
    planes)."""
    return engine.plan_params(params, keep_fp=False, with_planes=False)
