"""Parameter specs and the basic layers, through the CIM execution layer.

Every layer module defines a ``*_spec(cfg) -> dict[str, ParamSpec]``;
``init_params(generator, spec)`` materializes the weights on the
generator's device. One source of truth for shapes and init.

A linear layer's weight leaf is a plain tensor (planned on the fly per
call: ``engine.matmul``) or a precomputed ``engine.PlannedWeights`` (the
weight-stationary serving path: codes, colsums and planes are reused
across every forward), so the paper's macro is a per-layer execution
mode (``CIMPolicy``), not a separate model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import CIMPolicy
from repro_torch.core import engine
from repro_torch.core.engine import PlannedWeights

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == ndim
    init: str = "normal"  # normal | zeros | ones | normal:<std> | uniform:<s> | fanin
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_one(generator: torch.Generator, spec: ParamSpec) -> torch.Tensor:
    kind, _, arg = spec.init.partition(":")
    dev = generator.device
    if kind == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if kind == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if kind in ("normal", "fanin"):
        if kind == "normal":
            std = float(arg) if arg else 0.02
        else:  # the leading dim is the fan-in, as in the JAX package
            fan_in = spec.shape[0] if spec.shape else 1
            std = (1.0 / max(fan_in, 1)) ** 0.5
        z = torch.randn(spec.shape, generator=generator, device=dev)
        return (std * z).to(spec.dtype)
    if kind == "uniform":
        s = float(arg) if arg else 1.0
        u = torch.rand(spec.shape, generator=generator, device=dev)
        return ((2.0 * u - 1.0) * s).to(spec.dtype)
    raise ValueError(f"unknown init '{spec.init}'")


def init_params(generator: torch.Generator, spec_tree: Any,
                dtype: torch.dtype | None = None) -> Any:
    """Materialize a (nested dict of) ParamSpec into tensors, drawn in
    order from ``generator`` on its device (the JAX package's
    ``jax.random`` streams cannot be replayed; its parameters come across
    with ``convert.to_torch``). ``dtype`` casts each leaf as it is drawn:
    the values a cast of the whole tree gives, at the peak memory of one
    float32 leaf."""
    if isinstance(spec_tree, ParamSpec):
        leaf = _init_one(generator, spec_tree)
        return leaf if dtype is None else leaf.to(dtype)
    return {k: init_params(generator, v, dtype)
            for k, v in spec_tree.items()}


# ---------------------------------------------------------------------------
# Linear through the CIM execution layer
# ---------------------------------------------------------------------------


def linear_spec(
    d_in: int,
    d_out: int,
    in_axis: str | None,
    out_axis: str | None,
    *,
    bias: bool = False,
    init: str = "fanin",
) -> dict:
    spec = {"w": ParamSpec((d_in, d_out), (in_axis, out_axis), init)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (out_axis,), "zeros")
    return spec


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
    if isinstance(w, dict):  # the older {'w_q', 'w_s'} int8 serving form
        from repro_torch.serve.quantized import dequantize_weight

        w = dequantize_weight(w, x.dtype)
    if policy is None or policy.mode == "fp" or not cim_enabled:
        wd = plan.best_weights(x.dtype) if plan is not None else w
        y = x @ wd.to(x.dtype)
    elif plan is not None:
        # Weight-stationary: all weight-side transforms precomputed.
        y = engine.execute(x, plan, policy, generator=generator)
    else:
        # Fresh weights: plan per call.
        y = engine.matmul(x, w, policy, generator=generator)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms / embeddings / MLPs
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int, axis: str = "embed") -> dict:
    return {"scale": ParamSpec((d,), (axis,), "ones")}


def rmsnorm_apply(params: Params, x: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_spec(d: int, axis: str = "embed") -> dict:
    return {
        "scale": ParamSpec((d,), (axis,), "ones"),
        "bias": ParamSpec((d,), (axis,), "zeros"),
    }


def layernorm_apply(params: Params, x: torch.Tensor, eps: float
                    ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = (y * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(x.dtype)


def embedding_spec(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), "normal:0.02")}


def embedding_apply(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def mlp_spec(d: int, d_ff: int, act: str) -> dict:
    if act == "silu":  # SwiGLU
        return {
            "gate": linear_spec(d, d_ff, "embed", "mlp"),
            "up": linear_spec(d, d_ff, "embed", "mlp"),
            "down": linear_spec(d_ff, d, "mlp", "embed"),
        }
    return {
        "up": linear_spec(d, d_ff, "embed", "mlp"),
        "down": linear_spec(d_ff, d, "mlp", "embed"),
    }


class _Logistic(torch.autograd.Function):
    """``lax.logistic`` as XLA runs it: forward ``1 / (1 + exp(-x))``
    rounded after each op in x's dtype (in bfloat16, ``torch.sigmoid``,
    rounded once, differs in about a third of the values); gradient
    ``g * (y * (1 - y))``, the JAX package's rule. Autograd through the
    forward's ops would give ``inf * 0 = NaN`` where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, rounded per op (``_sigmoid``)."""
    return x * _sigmoid(x)


# The smallest normal float32: XLA on the CPU runs bfloat16 elementwise
# ops in float32 and flushes results below it to zero.
_F32_TINY = 2.0 ** -126


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x**3)))``, each op in
    float32, flushed to zero below the normal range and rounded to x's
    dtype, with the constants rounded to that dtype: ``jax.nn.gelu``
    (approximate) as XLA runs it. ``F.gelu(approximate="tanh")`` rounds
    once, and in bfloat16 differs from it in 1518 of the 34048 finite
    inputs below 64 in magnitude."""
    dt = x.dtype

    def op(t):
        return torch.where(t.abs() < _F32_TINY, t * 0, t).to(dt).float()

    def const(v):
        return torch.tensor(v, dtype=torch.float64).to(dt).float()

    xf = op(x.float())
    cube = op(op(xf * xf) * xf)
    inner = op(const(math.sqrt(2 / math.pi)) * op(xf + op(const(0.044715)
                                                          * cube)))
    cdf = op(0.5 * op(1.0 + op(torch.tanh(inner))))
    return op(xf * cdf).to(dt)


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    act: str,
    policy: CIMPolicy | None,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    en = policy.apply_to_mlp if policy else False
    kw = dict(cim_enabled=en, generator=generator)
    if act == "silu":
        g = linear_apply(params["gate"], x, policy, **kw)
        u = linear_apply(params["up"], x, policy, **kw)
        h = silu(g) * u
    else:
        u = linear_apply(params["up"], x, policy, **kw)
        h = _gelu_tanh(u)  # jax.nn.gelu's default
    return linear_apply(params["down"], h, policy, **kw)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
