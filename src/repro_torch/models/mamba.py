"""Mamba (S6 selective state space) block of the jamba hybrid.

``in_proj`` and ``out_proj`` run through the macro (``apply_to_mlp``);
``x_proj`` and ``dt_proj`` stay digital (read through ``maybe_dequant``
when planned), as do the causal conv and the selective scan, a
data-dependent recurrence accumulated in float32.

Two scans: 'sequential' steps through time; 'chunked' (the default) runs
an associative scan inside each chunk of ``chunk_size`` steps, with the
JAX package's combine tree, and carries the state across chunks. Decode
keeps a (conv window, ssm state) cache and costs O(1) per token.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import CIMPolicy, ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamSpec
from repro_torch.serve.quantized import maybe_dequant

F32 = torch.float32


class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, d_conv - 1, d_inner] trailing inputs
    ssm: torch.Tensor  # [B, d_inner, d_state]


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, mc.d_state, mc.d_conv


def mamba_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, dt_rank, d_state, d_conv = _dims(cfg)
    return {
        "in_proj": common.linear_spec(d, 2 * d_in, "embed", "mlp"),
        "conv_w": ParamSpec((d_conv, d_in), (None, "mlp"), "fanin"),
        "conv_b": ParamSpec((d_in,), ("mlp",), "zeros"),
        "x_proj": common.linear_spec(d_in, dt_rank + 2 * d_state, "mlp",
                                     None),
        "dt_proj": common.linear_spec(dt_rank, d_in, None, "mlp", bias=True,
                                      init="uniform:0.1"),
        # S4D-real init (transformer.init): a_log = log(1..d_state).
        "a_log": ParamSpec((d_in, d_state), ("mlp", None), "zeros"),
        "d_skip": ParamSpec((d_in,), ("mlp",), "ones"),
        "out_proj": common.linear_spec(d_in, d, "mlp", "embed"),
    }


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
               device="cuda") -> MambaCache:
    d_in, _, d_state, d_conv = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, d_in), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_in, d_state), dtype=dtype, device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as the JAX package computes
    it, ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to x
    past a threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B, L, C], w: [K, C]."""
    k, l = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + l, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssm_raw(params, xc, cfg: ModelConfig):
    """Input-dependent (dt, B, C) and the static A, before discretization
    (the chunked scan expands the d_state axis one chunk at a time)."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = xc @ maybe_dequant(params["x_proj"]["w"], xc.dtype)
    dt, b_mat, c_mat = torch.split(proj, [dt_rank, d_state, d_state],
                                   dim=-1)
    dt = _softplus(dt @ maybe_dequant(params["dt_proj"]["w"], xc.dtype)
                   + params["dt_proj"]["b"].to(xc.dtype))  # [..., d_in]
    a = -torch.exp(params["a_log"].to(F32))  # [d_in, d_state]
    return dt, b_mat, c_mat, a


def _discretize(dt, xc, b_mat, a):
    """ZOH for A, Euler for B (the Mamba paper's discretization)."""
    a_bar = torch.exp(dt[..., None].to(F32) * a)
    bx = (dt * xc)[..., None].to(F32) * b_mat[..., None, :].to(F32)
    return a_bar, bx


def _ssm_params(params, xc, cfg):
    """Discretized (a_bar, bx, c_mat): the decode and sequential paths."""
    dt, b_mat, c_mat, a = _ssm_raw(params, xc, cfg)
    a_bar, bx = _discretize(dt, xc, b_mat, a)
    return a_bar, bx, c_mat


def _scan_sequential(a_bar, bx, c_mat, h0):
    """a_bar/bx: [B, L, d_in, d_state], c: [B, L, d_state]."""
    h, ys = h0, []
    for t in range(a_bar.shape[1]):
        h = a_bar[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, c_mat[:, t]))
    return torch.stack(ys, dim=1), h


def _combine(p, q):
    (a1, b1), (a2, b2) = p, q
    return a1 * a2, a2 * b1 + b2


def associative_scan(elems, dim: int = 1):
    """Inclusive scan of (a, b) pairs under ``_combine`` along ``dim``, with
    ``lax.associative_scan``'s combine tree: neighbours combined pairwise,
    the half-length scan by recursion, then the even positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        return e[(slice(None),) * dim + (slice(start, stop, step),)]

    odd = associative_scan(_combine([sl(e, 0, -1, 2) for e in elems],
                                    [sl(e, 1, None, 2) for e in elems]), dim)
    if n % 2 == 0:
        odd_in = [sl(e, 0, -1) for e in odd]
    else:
        odd_in = odd
    even = _combine(odd_in, [sl(e, 2, None, 2) for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        sl(full, 0, 1).copy_(sl(e, 0, 1))
        sl(full, 2, None, 2).copy_(ev)
        sl(full, 1, None, 2).copy_(od)
        out.append(full)
    return out


def _scan_chunked(dt, xc, b_mat, c_mat, a, h0, chunk: int):
    """Chunks of ``chunk`` steps: an associative scan inside each, the
    state carried across; the d_state expansion happens per chunk.
    Padding has dt = 0, so a_bar = 1 and the state is unchanged."""
    b, l, d_in = dt.shape
    pad = (-l) % chunk
    if pad:
        def padded(t):
            return torch.nn.functional.pad(t, (0, 0, 0, pad))
        dt, xc, b_mat, c_mat = (padded(t) for t in (dt, xc, b_mat, c_mat))
    dtxc = dt * xc
    h, ys = h0, []
    for c0 in range(0, l + pad, chunk):
        sl = slice(c0, c0 + chunk)
        ab = torch.exp(dt[:, sl, :, None].to(F32) * a)
        bxt = dtxc[:, sl, :, None].to(F32) * b_mat[:, sl, None, :].to(F32)
        acc_a, acc_b = associative_scan((ab, bxt), dim=1)
        h_t = acc_a * h[:, None] + acc_b  # the state at every step
        y = torch.einsum("blds,bls->bld", h_t, c_mat[:, sl].to(F32))
        ys.append(y.to(dt.dtype))  # the recurrence itself stays float32
        h = h_t[:, -1]
    return torch.cat(ys, dim=1)[:, :l], h


def mamba_apply(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    cfg: ModelConfig,
    *,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
    return_cache: bool = False,
):
    """Training / prefill forward, the state starting at zero. With
    ``return_cache`` also the MambaCache decode continues from (the last
    d_conv - 1 raw conv inputs and the final ssm state, float32)."""
    d_in, _, d_state, d_conv = _dims(cfg)
    en = policy.apply_to_mlp if policy else False
    xz = common.linear_apply(params["in_proj"], x, policy, cim_enabled=en,
                             generator=generator)
    xc_raw, z = torch.chunk(xz, 2, dim=-1)
    xc = common.silu(_causal_conv(xc_raw, params["conv_w"], params["conv_b"]))
    h0 = torch.zeros((x.shape[0], d_in, d_state), dtype=F32,
                     device=x.device)
    if cfg.mamba.scan_impl == "chunked":
        dt, b_mat, c_mat, a = _ssm_raw(params, xc, cfg)
        y, h_last = _scan_chunked(dt, xc, b_mat, c_mat, a, h0,
                                  cfg.mamba.chunk_size)
    else:
        a_bar, bx, c_mat = _ssm_params(params, xc, cfg)
        y, h_last = _scan_sequential(a_bar.to(F32), bx.to(F32),
                                     c_mat.to(F32), h0)
    y = y.to(xc.dtype) + params["d_skip"].to(xc.dtype) * xc
    y = y * common.silu(z)
    out = common.linear_apply(params["out_proj"], y, policy, cim_enabled=en,
                              generator=generator)
    if not return_cache:
        return out
    tail = xc_raw[:, -(d_conv - 1):, :]
    tail = torch.nn.functional.pad(tail, (0, 0, d_conv - 1 - tail.shape[1],
                                          0))
    return out, MambaCache(conv=tail.to(F32), ssm=h_last.to(F32))


def mamba_decode_step(
    params: dict,
    x: torch.Tensor,  # [B, 1, D]
    cfg: ModelConfig,
    cache: MambaCache,
    *,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, MambaCache]:
    """One token with the (conv, ssm) state; the new ssm state is
    float32, the new conv window in the dtype of its inputs."""
    en = policy.apply_to_mlp if policy else False
    xz = common.linear_apply(params["in_proj"], x, policy, cim_enabled=en,
                             generator=generator)
    xc, z = torch.chunk(xz[:, 0], 2, dim=-1)  # [B, d_in]
    window = torch.cat([cache.conv, xc[:, None]], dim=1)  # [B, K, d_in]
    dt = torch.promote_types(window.dtype, params["conv_w"].dtype)
    conv = torch.einsum("bkc,kc->bc", window.to(dt),
                        params["conv_w"].to(dt))
    xc = common.silu(conv + params["conv_b"])
    a_bar, bx, c_mat = _ssm_params(params, xc, cfg)
    h = a_bar.to(F32) * cache.ssm.to(F32) + bx.to(F32)
    y = torch.einsum("bds,bs->bd", h, c_mat.to(F32)).to(xc.dtype)
    y = y + params["d_skip"].to(y.dtype) * xc
    y = y * common.silu(z)
    out = common.linear_apply(params["out_proj"], y[:, None], policy,
                              cim_enabled=en, generator=generator)
    return out, MambaCache(conv=window[:, 1:], ssm=h)
