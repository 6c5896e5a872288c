"""Launch-cell feasibility: the analytic part of the reference's dry run.

The reference's ``repro.launch.dryrun`` lowers and compiles every
(arch x shape x mesh) cell for a 512-chip TPU pod. What carries over to
one card without compiling is its name and cost check:
:func:`validate_cell` (the ``repro_torch.sweep --dry-run`` hook) checks
an arch and a shape against the registries and evaluates the analytic
cost model (parameter counts, :func:`model_flops`).
"""

from __future__ import annotations

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = new tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def validate_cell(
    arch: str | None, shape_name: str | None = None
) -> dict:
    """Name + analytic feasibility of one launch cell, no compile.

    Raises ``ValueError`` with the known names on an unknown arch or
    shape; returns {} unless both are given.
    """
    if arch is not None and arch not in ARCH_IDS:
        raise ValueError(
            f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}"
        )
    if shape_name is not None and shape_name not in SHAPES:
        raise ValueError(
            f"unknown shape {shape_name!r}; known: {sorted(SHAPES)}"
        )
    if arch is None or shape_name is None:
        return {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape),
    }
