"""AdamW with schedules, global-norm clipping and gradient compression.

Functional, as the JAX package's: ``apply_updates`` returns new
parameter and state trees and changes none of its inputs. The state
mirrors the parameter tree (nested dicts of tensors), so whatever shards
or places the parameters places m and v the same way.

Gradient compression: int8 error-feedback quantization of the gradient
before a cross-replica reduction. Error feedback keeps a residual, so
the compression error cancels over steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.quant import true_divide

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Params
    v: Params


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts (the first tree's
    structure)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _device(params: Params) -> torch.device:
    return tree_leaves(params)[0].device


def init_state(params: Params, *, dtype=torch.float32) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=_device(params)), zeros,
        tree_map(torch.clone, zeros))


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warm-up, then the
    cosine, linear or constant decay to ``min_lr_frac``, in float32.
    Divisions are IEEE's on every device (``quant.true_divide``; a Python
    divisor on CUDA, or a Python dividend anywhere, multiplies by a
    reciprocal in torch), as the JAX package's eager ops divide."""
    step = step.to(torch.float32)
    warm = torch.clamp(true_divide(step, max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp(true_divide(step - cfg.warmup_steps,
                                   max(cfg.total_steps - cfg.warmup_steps,
                                       1)), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones((), device=step.device)
    return cfg.lr * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply_updates(
    params: Params,
    grads: Params,
    state: AdamWState,
    cfg: OptimizerConfig,
) -> tuple[Params, AdamWState, dict]:
    """One AdamW step; returns (params, state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(step_f, b1), step_f)
    bc2 = 1 - torch.pow(torch.full_like(step_f, b2), step_f)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step, new_m, new_v), metrics


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------


class CompressionState(NamedTuple):
    residual: Params  # error-feedback accumulator


def init_compression(params: Params) -> CompressionState:
    return CompressionState(
        tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def compress_decompress(
    grads: Params, comp: CompressionState
) -> tuple[Params, CompressionState, dict]:
    """Simulate int8 quantization of the gradient reduction's payload.

    g_q = dequant(quant(g + residual)); residual' = (g + residual) - g_q.
    The transmitted tensor is int8; the returned gradient is its
    dequantization, so training sees the compression error, and error
    feedback cancels it over steps.
    """

    def one(g, r):
        x = g.to(torch.float32) + r
        amax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-12)
        scale = true_divide(amax, 127.0)
        q = torch.clamp(torch.round(x / scale), -127, 127)
        deq = q * scale
        return deq.to(g.dtype), x - deq

    out = tree_map(one, grads, comp.residual)
    new_r = _pick(out, 1)
    err = sum(torch.sum(torch.square(r)) for r in tree_leaves(new_r))
    return _pick(out, 0), CompressionState(new_r), {"compress_err_sq": err}
