"""RWKV-6 ("Finch") block: data-dependent-decay linear attention.

Attention-free: a time-mix (the WKV recurrence) and a channel-mix. The
r/k/v/g/o and channel-mix projections are weight-stationary and run
through the macro (``apply_to_attn_proj`` and ``apply_to_mlp``); the WKV
recurrence, the token shift and the data-dependent decay stay digital.

The WKV state per head is [hd, hd], so decoding costs O(1) per token.
Dtypes follow the JAX package's promotion op by op: the float32 ``mu_*``,
LoRA and decay parameters lift the bfloat16 activations to float32, so the
mixed inputs and the r/k/v/g projections run in float32, the recurrence
in float32, and ``_group_norm`` returns to the activation dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import CIMPolicy, ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

_MIX_NAMES = ("w", "k", "v", "r", "g")  # RWKV6 ddlerp output order


class RWKVCache(NamedTuple):
    shift_tm: torch.Tensor  # [B, D] last input to time-mix
    shift_cm: torch.Tensor  # [B, D] last input to channel-mix
    state: torch.Tensor  # [B, H, hd, hd] WKV state


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_size
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def rwkv_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    rc = cfg.rwkv
    h, hd = _dims(cfg)
    spec = {
        "mu_x": ParamSpec((d,), ("embed",), "normal:0.02"),
        "mix_w1": ParamSpec((d, 5 * rc.mix_lora), ("embed", None), "fanin"),
        "mix_w2": ParamSpec((5, rc.mix_lora, d), (None, None, "embed"),
                            "fanin"),
        "decay_w0": ParamSpec((d,), ("embed",), "normal:0.02"),
        "decay_w1": ParamSpec((d, rc.decay_lora), ("embed", None), "fanin"),
        "decay_w2": ParamSpec((rc.decay_lora, d), (None, "embed"), "fanin"),
        "bonus_u": ParamSpec((h, hd), ("heads", None), "normal:0.02"),
        "ln_out": common.layernorm_spec(d),
        "wr": common.linear_spec(d, d, "embed", "heads"),
        "wk": common.linear_spec(d, d, "embed", "heads"),
        "wv": common.linear_spec(d, d, "embed", "heads"),
        "wg": common.linear_spec(d, d, "embed", "heads"),
        "wo": common.linear_spec(d, d, "heads", "embed"),
    }
    for nm in _MIX_NAMES:
        spec[f"mu_{nm}"] = ParamSpec((d,), ("embed",), "normal:0.02")
    return spec


def channelmix_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "mu_k": ParamSpec((d,), ("embed",), "normal:0.02"),
        "mu_r": ParamSpec((d,), ("embed",), "normal:0.02"),
        "wk": common.linear_spec(d, cfg.d_ff, "embed", "mlp"),
        "wv": common.linear_spec(cfg.d_ff, d, "mlp", "embed"),
        "wr": common.linear_spec(d, d, "embed", "embed"),
    }


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
               device="cuda") -> RWKVCache:
    h, hd = _dims(cfg)
    d = cfg.d_model

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return RWKVCache(shift_tm=z(batch, d), shift_cm=z(batch, d),
                     state=z(batch, h, hd, hd))


def _ddlerp(params, x, xprev) -> dict:
    """RWKV6 data-dependent token-shift interpolation: name -> mixed input
    [B, L, D] for w/k/v/r/g."""
    xx = xprev - x
    xxx = x + xx * params["mu_x"]
    lora = torch.tanh(xxx @ params["mix_w1"])  # [B, L, 5*ml]
    b, l, _ = lora.shape
    lora = lora.reshape(b, l, 5, -1)
    offs = torch.einsum("blfm,fmd->blfd", lora, params["mix_w2"])
    return {nm: x + xx * (params[f"mu_{nm}"] + offs[:, :, i])
            for i, nm in enumerate(_MIX_NAMES)}


def _decay(params, x_w) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1)."""
    lora = torch.tanh(x_w @ params["decay_w1"]) @ params["decay_w2"]
    return torch.exp(-torch.exp(params["decay_w0"] + lora))


def _wkv_step(state, rkvw, u):
    """state: [B, H, hd, hd]; r/k/v/w: [B, H, hd]; u: [H, hd]."""
    r, k, v, w = rkvw
    kv = k[..., :, None] * v[..., None, :]  # [B, H, hd, hd]
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    return w[..., :, None] * state + kv, y


def _wkv_scan(r, k, v, w, u, state0, chunk: int):
    """The WKV recurrence over time, in chunks of ``chunk`` steps (the JAX
    package rematerializes each chunk in training). Padded steps have
    r, k, v = 0 and w = 1, so they leave the state unchanged.

    r/k/v/w: [B, L, H, hd]. Returns ([B, L, H, hd], final state).
    """
    l = r.shape[1]
    pad = (-l) % chunk
    if pad:
        def zeros(a, value=0.0):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad),
                                           value=value)
        r, k, v, w = zeros(r), zeros(k), zeros(v), zeros(w, 1.0)
    state, ys = state0, []
    for t in range(l + pad):
        state, y = _wkv_step(state, (r[:, t], k[:, t], v[:, t], w[:, t]), u)
        ys.append(y)
    return torch.stack(ys, dim=1)[:, :l], state


def _group_norm(params, y, eps):
    """Per-head layernorm on [B, L, H, hd] -> [B, L, D]."""
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    yn = (y - mu) * torch.rsqrt(var + eps)
    b, l, h, hd = y.shape
    yn = yn.reshape(b, l, h * hd)
    return yn * params["ln_out"]["scale"] + params["ln_out"]["bias"]


def _shifted(x, shift_state):
    """The previous token's input at every position: ``shift_state`` (zeros
    when None) before the first."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, 0])
    return torch.cat([shift_state[:, None], x[:, :-1]], dim=1)


def timemix_apply(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    cfg: ModelConfig,
    *,
    shift_state: torch.Tensor | None = None,  # [B, D]
    wkv_state: torch.Tensor | None = None,  # [B, H, hd, hd]
    chunk: int = 128,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new shift state, new WKV state)."""
    b, l, d = x.shape
    h, hd = _dims(cfg)
    mixed = _ddlerp(params, x, _shifted(x, shift_state))

    en = policy.apply_to_attn_proj if policy else False

    def proj(name, inp):
        return common.linear_apply(params[name], inp, policy, cim_enabled=en,
                                   generator=generator)

    def heads(a):
        return a.reshape(b, l, h, hd).to(torch.float32)

    r = heads(proj("wr", mixed["r"]))
    k = heads(proj("wk", mixed["k"]))
    v = heads(proj("wv", mixed["v"]))
    g = proj("wg", mixed["g"])
    w = heads(_decay(params, mixed["w"]))

    if wkv_state is None:
        wkv_state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                device=x.device)
    ys, new_state = _wkv_scan(r, k, v, w,
                              params["bonus_u"].to(torch.float32),
                              wkv_state.to(torch.float32), chunk)
    y = _group_norm(params, ys, cfg.norm_eps).to(x.dtype)
    y = y * common.silu(g)
    return proj("wo", y), x[:, -1], new_state


def channelmix_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    shift_state: torch.Tensor | None = None,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, new shift state)."""
    xx = _shifted(x, shift_state) - x
    x_k = x + xx * params["mu_k"]
    x_r = x + xx * params["mu_r"]
    en = policy.apply_to_mlp if policy else False

    def proj(name, inp):
        return common.linear_apply(params[name], inp, policy, cim_enabled=en,
                                   generator=generator)

    k = torch.square(torch.relu(proj("wk", x_k)))
    kv = proj("wv", k)
    return common._sigmoid(proj("wr", x_r)) * kv, x[:, -1]
