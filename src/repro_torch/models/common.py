"""Linear layers through the CIM execution layer.

A weight leaf is either a plain tensor (digital only in this slice) or a
precomputed ``engine.PlannedWeights`` (the weight-stationary serving
path: codes, colsums and planes are reused across every forward). The
one-shot straight-through path for fresh weights comes with training
(ROADMAP slice 6).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import CIMPolicy
from repro_torch.core import engine
from repro_torch.core.engine import PlannedWeights

Params = dict[str, Any]


def linear_apply(
    params: Params,
    x: torch.Tensor,
    policy: CIMPolicy | None = None,
    *,
    cim_enabled: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """y = x @ w (+ b), optionally through the macro model.

    ``cim_enabled`` gates per-matmul-family application; bias addition is
    always digital (the macro only produces the MAC).
    """
    w = params["w"]
    plan = w if isinstance(w, PlannedWeights) else None
    if policy is None or policy.mode == "fp" or not cim_enabled:
        wd = plan.best_weights(x.dtype) if plan is not None else w
        y = x @ wd.to(x.dtype)
    elif plan is not None:
        y = engine.execute(x, plan, policy, generator=generator)
    else:
        raise NotImplementedError(
            "a CIM policy needs planned weights (engine.plan_weights / "
            "resnet.plan_params); the straight-through path for fresh "
            "weights comes with training, slice 6 of ROADMAP.md"
        )
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
