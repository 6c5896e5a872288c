"""Mixture-of-Experts block.

Digital path ('fp', dispatch='grouped'): GShard-style local routing groups
with capacity. Tokens are routed within groups of ~group_size; each
token's k-th choice claims a slot in its expert's queue, overflow choices
are dropped, and the experts run as three einsums over a [G, E, C, d]
buffer. dispatch='ragged' sorts the choices by expert and runs one matmul
per contiguous expert segment (no drops). The router is always digital.

CIM path (any mode but 'fp', ``policy.apply_to_experts``). Under the
default dispatch='grouped' it is the JAX package's masked loop over every
expert through the macro on every token, E/k times the routed compute,
for accuracy studies. Under dispatch='ragged' the port departs from the
JAX package, which loops there too: each expert runs through the macro
on the tokens routed to it and on no others, with no drops (the ragged
path's sort by expert, the segment sizes read on the host, three macro
calls per expert with tokens, none for an expert without). That is the
sparse model a deployment serves, and each expert's per-tensor
activation quantizer then takes its range over its own tokens only. The
two give each token its k weighted outputs added in expert order into
the activation-dtype sum, so they agree bit for bit where every token
goes to every expert. A bank planned by ``engine.plan_params``
([E, K, N] codes) is read one expert at a time as a view
(``PlannedWeights.layer``): the JAX package indexes the planned bank as
an array there and fails, so its served path is its unplanned one, which
plans the same [K, N] slice per call with the same per-column scales.

Spans: ``repro_torch.moe.route`` over the router, the sort and host read,
the gathers and the combine (never over an expert's projections), and
``repro_torch.moe.expert`` over each expert's three macro calls.

Shared experts (qwen2-moe): one fused SwiGLU of width d_shared with a
sigmoid gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import CIMPolicy, MoEConfig, ModelConfig
from repro_torch.core.engine import PlannedWeights
from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.common import ParamSpec
from repro_torch.serve.quantized import maybe_dequant


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor  # load-balance loss (scalar)
    router_entropy: torch.Tensor


def moe_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    mo = cfg.moe
    assert mo is not None
    spec = {
        "router": {"w": ParamSpec((d, mo.n_experts), ("embed", "experts"),
                                  "normal:0.02")},
        "gate": ParamSpec((mo.n_experts, d, mo.d_expert),
                          ("experts", "embed", "mlp"), "fanin"),
        "up": ParamSpec((mo.n_experts, d, mo.d_expert),
                        ("experts", "embed", "mlp"), "fanin"),
        "down": ParamSpec((mo.n_experts, mo.d_expert, d),
                          ("experts", "mlp", "embed"), "fanin"),
    }
    if mo.d_shared:
        spec["shared"] = common.mlp_spec(d, mo.d_shared, "silu")
        spec["shared_gate"] = {"w": ParamSpec((d, 1), ("embed", None),
                                              "normal:0.02")}
    return spec


def top_k_stable(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (as
    ``lax.top_k``; ``torch.topk`` promises no order among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, x2, mo: MoEConfig, generator=None):
    """x2: [T, d] -> (top_p [T, k] in x2's dtype, top_e [T, k], metrics).
    Jitter is drawn only from a caller's ``generator``."""
    logits = x2 @ params["router"]["w"].to(x2.dtype)  # digital
    if mo.router_jitter and generator is not None:
        logits = logits + mo.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_e = top_k_stable(probs, mo.top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # Load-balance aux loss (Switch-style): E * sum_e f_e * P_e.
    e = mo.n_experts
    flat = top_e.reshape(-1)
    f = torch.zeros(e, dtype=torch.float32, device=x2.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=torch.float32, device=x2.device))
    aux = e * torch.sum(f * torch.mean(probs, dim=0))
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), dim=-1))
    return top_p.to(x2.dtype), top_e, MoEMetrics(aux, entropy)


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` summed in float32 and rounded once to a's dtype, as XLA
    runs a bfloat16 dot (torch's bfloat16 CPU product rounds elsewhere in
    about one of 10^4 outputs)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32)).to(
        a.dtype)


def _bank(params, name, dtype) -> torch.Tensor:
    """An expert bank [E, K, N] as dense weights, read through its plan
    when the tree was planned (int8 serving or CIM)."""
    return maybe_dequant(params[name], dtype)


def expert(bank, e: int):
    """Expert ``e`` of a bank: a view of slice ``e`` of a plain [E, K, N]
    tensor or of every field of a planned bank."""
    return bank.layer(e) if isinstance(bank, PlannedWeights) else bank[e]


def _constrain_expert_buffer(xe: torch.Tensor) -> torch.Tensor:
    """Shard the [G, E, C, d] dispatch buffer: routing groups over the
    data axes when G divides, else expert-parallel over them
    (``sharding.expert_buffer_spec``). The identity without an active
    mesh; under one (world size 1) the spec is computed and ``xe``
    returned unchanged."""
    mesh = sharding._ctx_mesh()
    if mesh is None:
        return xe
    sharding.expert_buffer_spec(tuple(xe.shape), mesh)
    return xe


def _capacity(t_group: int, mo: MoEConfig) -> int:
    cap = int(t_group * mo.top_k * mo.capacity_factor / mo.n_experts)
    return max(cap, mo.top_k)


def _dispatch_grouped(params, x2, top_p, top_e, mo: MoEConfig, dtype):
    """GShard-style grouped capacity dispatch.

    Tokens split into routing groups of ~group_size; within a group the
    (token, choice) pairs claim queue slots choice-major (every first
    choice before any second), and a choice past its expert's capacity
    ``C = Tg*k*cf/E`` is dropped (combine weight zero). Dropped choices
    scatter zeros into slot 0. The [G, E, C, d] buffers are constrained
    as the JAX package constrains them (``_constrain_expert_buffer``).
    """
    t, d = x2.shape
    e, k = mo.n_experts, mo.top_k
    g = max(1, t // mo.group_size)
    while t % g:  # t is B*S; fewer groups if it does not divide
        g -= 1
    tg = t // g
    cap = _capacity(tg, mo)

    xg = x2.reshape(g, tg, d)
    eg = top_e.reshape(g, tg, k)
    pg = top_p.reshape(g, tg, k).to(torch.float32)

    onehot = F.one_hot(eg, e).to(torch.float32)  # [G, Tg, k, E]
    flat = onehot.permute(0, 2, 1, 3).reshape(g, k * tg, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat  # [G, k*Tg, E]
    pos = pos_flat.reshape(g, k, tg, e).permute(0, 2, 1, 3)
    keep = (pos < cap) * onehot  # [G, Tg, k, E]
    kept = torch.sum(keep, dim=-1)  # [G, Tg, k] in {0, 1}
    slot = torch.sum(pos * keep, dim=-1).to(torch.long)  # [G, Tg, k]

    upd = (xg[:, :, None, :] * kept[..., None]).to(dtype)  # [G, Tg, k, d]
    gi = torch.arange(g, device=x2.device)[:, None, None].expand(g, tg, k)
    xe = torch.zeros((g, e, cap, d), dtype=dtype, device=x2.device)
    xe.index_put_((gi.reshape(-1), eg.reshape(-1), slot.reshape(-1)),
                  upd.reshape(-1, d), accumulate=True)
    xe = _constrain_expert_buffer(xe)

    gate = _dot("gecd,edf->gecf", xe, _bank(params, "gate", dtype))
    up = _dot("gecd,edf->gecf", xe, _bank(params, "up", dtype))
    ye = _dot("gecf,efd->gecd", common.silu(gate) * up,
              _bank(params, "down", dtype))
    ye = _constrain_expert_buffer(ye)

    yt = ye[gi, eg, slot]  # [G, Tg, k, d]
    out = _dot("gtkd,gtk->gtd", yt, (pg * kept).to(dtype))
    return out.reshape(t, d)


def _dispatch_ragged(x2, top_p, top_e, mo: MoEConfig, swiglu):
    """Exact routing without drops: the (token, choice) pairs stable-sorted
    by expert, the segment sizes read on the host, ``swiglu(e, seg)`` on
    each non-empty contiguous segment (M = its tokens; the JAX package's
    ``lax.ragged_dot`` on the digital path), the outputs weighted by
    ``top_p``, then each token's k of them added in sorted (expert) order,
    one rounding per add, as the JAX package's scatter-add runs
    (``index_add_`` rounds otherwise in bfloat16) and as
    ``_experts_dense_cim`` adds them."""
    t, k = top_e.shape
    with tracing.span("repro_torch.moe.route"):
        flat_e = top_e.reshape(-1)  # [T*k]
        order = torch.argsort(flat_e, stable=True)
        sizes = torch.bincount(flat_e, minlength=mo.n_experts).tolist()
        xs = x2[order // k]  # [T*k, d]
    ys, start = [], 0
    for e, size in enumerate(sizes):
        if size:
            ys.append(swiglu(e, xs[start:start + size]))
        start += size
    with tracing.span("repro_torch.moe.route"):
        contrib = top_p.reshape(-1)[order][:, None] * torch.cat(ys)
        rank = torch.argsort(order)  # sorted position of each (token, choice)
        contrib = contrib[rank].reshape(t, k, -1)
        first = torch.argsort(rank.reshape(t, k), dim=1)  # add order per token
        rows = torch.arange(t, device=x2.device)
        out = torch.zeros_like(x2)
        for c in range(k):
            out = out + contrib[rows, first[:, c]]
        return out


def _swiglu_digital(banks: dict, e: int, x):
    """Expert ``e``'s SwiGLU on x [M, d] from the dense banks."""
    h = (common.silu(_dot("td,df->tf", x, banks["gate"][e]))
         * _dot("td,df->tf", x, banks["up"][e]))
    return _dot("tf,fd->td", h, banks["down"][e])


def _swiglu_cim(params, e: int, x, policy, generator=None):
    """Expert ``e``'s SwiGLU on x [M, d], its three projections through
    the macro (the planned bank's view): one ``moe.expert`` span."""
    with tracing.span("repro_torch.moe.expert"):
        g = common.linear_apply({"w": expert(params["gate"], e)}, x, policy,
                                generator=generator)
        u = common.linear_apply({"w": expert(params["up"], e)}, x, policy,
                                generator=generator)
        return common.linear_apply({"w": expert(params["down"], e)},
                                   common.silu(g) * u, policy,
                                   generator=generator)


def _experts_dense_cim(params, x2, top_p, top_e, mo: MoEConfig, policy,
                       generator=None):
    """Masked loop over every expert through the macro; each expert's
    weighted output is added into the activation-dtype sum in expert
    order."""
    t, d = x2.shape
    out = torch.zeros((t, d), dtype=x2.dtype, device=x2.device)
    zero = torch.zeros((), dtype=top_p.dtype, device=x2.device)
    for e in range(mo.n_experts):
        w_e = torch.sum(torch.where(top_e == e, top_p, zero), dim=-1)  # [T]
        out = out + w_e[:, None] * _swiglu_cim(params, e, x2, policy,
                                               generator)
    return out


def moe_apply(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    cfg: ModelConfig,
    *,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, MoEMetrics]:
    mo = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    with tracing.span("repro_torch.moe.route"):
        top_p, top_e, metrics = _router(params, x2, mo, generator=generator)

    cim = (policy is not None and policy.mode != "fp"
           and policy.apply_to_experts)
    if mo.dispatch == "ragged":
        if cim:
            def swiglu(e, seg):
                return _swiglu_cim(params, e, seg, policy, generator)
        else:
            banks = {n: _bank(params, n, x2.dtype)
                     for n in ("gate", "up", "down")}

            def swiglu(e, seg):
                return _swiglu_digital(banks, e, seg)
        out = _dispatch_ragged(x2, top_p, top_e, mo, swiglu)
    elif cim:
        out = _experts_dense_cim(params, x2, top_p, top_e, mo, policy,
                                 generator)
    else:
        out = _dispatch_grouped(params, x2, top_p, top_e, mo, x2.dtype)

    if mo.d_shared:
        sh = common.mlp_apply(params["shared"], x2, "silu", policy)
        gate = common._sigmoid(x2 @ params["shared_gate"]["w"].to(x2.dtype))
        out = out + gate * sh

    return out.reshape(b, s, d), metrics
