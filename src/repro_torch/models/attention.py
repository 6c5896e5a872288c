"""GQA attention with causal/local masking, KV caches and cross-attention.

Weight projections route through the CIM execution layer (they are
weight-stationary); the attention core itself (QK^T, softmax, PV) is
activation x activation and stays digital, in float32.

Cache layouts:
  full cache  : k/v [B, C, KVH, hd], written at absolute position.
  ring cache  : C == window; slot = pos % window (local layers; RoPE is
                applied at write time with absolute positions so relative
                offsets survive the ring indexing).
Decode is one query token against the cache; prefill writes the cache in
bulk and runs the masked quadratic core. The port writes a cache in
place (slice assignment into the caller's tensors, ``index_copy_`` at a
decode step's device position) and returns the same ``KVCache``; the JAX
package returns updated copies. Every decode step writes all B rows at
the one position ``pos``, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import CIMPolicy, ModelConfig
from repro_torch.distributed.sharding import constrain_query
from repro_torch.models import common


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, C, KVH, hd]
    v: torch.Tensor  # [B, C, KVH, hd]


# The largest magnitude that rounds into float8_e4m3fn's finite range
# (448 plus half its last step; a tie at 464 rounds to even, 448).
_E4M3_ROUNDS_FINITE = 464.0


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the cache's storage dtype, converted as the JAX package's
    ``astype`` converts: torch saturates float8_e4m3fn at +-448, while the
    JAX package gives NaN beyond the finite range and for +-inf, with the
    input's sign (bytes 0x7F and 0xFF)."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    beyond = ~(x.abs() <= _E4M3_ROUNDS_FINITE)  # NaN and +-inf too
    return torch.where(beyond, nan, y.view(torch.uint8)).view(dtype)


def attn_spec(cfg: ModelConfig) -> dict:
    """The projections of self-attention, and of cross-attention (the same
    shapes; cross-attention uses no RoPE)."""
    d = cfg.d_model
    return {
        "wq": common.linear_spec(d, cfg.q_dim, "embed", "heads",
                                 bias=cfg.qkv_bias),
        "wk": common.linear_spec(d, cfg.kv_dim, "embed", "kv_heads",
                                 bias=cfg.qkv_bias),
        "wv": common.linear_spec(d, cfg.kv_dim, "embed", "kv_heads",
                                 bias=cfg.qkv_bias),
        "wo": common.linear_spec(cfg.q_dim, d, "heads", "embed"),
    }


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
    dtype=torch.float32, device="cuda",
) -> KVCache:
    c = min(window, max_len) if window else max_len
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _project_qkv(params, x, cfg: ModelConfig, policy: CIMPolicy | None,
                 generator=None):
    en = policy.apply_to_attn_proj if policy else False
    b, s, _ = x.shape
    q, k, v = (common.linear_apply(params[n], x, policy, cim_enabled=en,
                                   generator=generator)
               for n in ("wq", "wk", "wv"))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _gqa_core(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, KVH, hd]
    v: torch.Tensor,  # [B, T, KVH, hd]
    mask: torch.Tensor | None,  # broadcastable to [B, G, R, S, T], bool
    scale: float | None = None,  # on the scores; None: hd ** -0.5
) -> torch.Tensor:
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum(
        "bsgrh,btgh->bgrst", qg.to(torch.float32), k.to(torch.float32)
    ) * (hd**-0.5 if scale is None else scale)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def _flash_core(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, KVH, hd]
    v: torch.Tensor,  # [B, T, KVH, hd]
    *,
    q_positions: torch.Tensor,  # [S] absolute positions of the queries
    window: int = 0,
    block: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax (flash) attention: a loop over KV blocks that never
    materializes the [S, T] score matrix. Equal to ``_gqa_core`` up to
    float32 summation order. Causality and the window come from absolute
    positions; ``scale`` (None: hd ** -0.5) multiplies q in its dtype."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    rep = h // kvh
    scale = hd**-0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, rep, hd) * torch.tensor(scale, dtype=q.dtype)
    m = torch.full((b, kvh, rep, s), -torch.inf, device=q.device)
    l = torch.zeros((b, kvh, rep, s), device=q.device)
    acc = torch.zeros((b, kvh, rep, s, hd), device=q.device)
    for start in range(0, t, block):
        kblk = k[:, start:start + block]
        vblk = v[:, start:start + block]
        kv_pos = torch.arange(start, start + kblk.shape[1], device=q.device)
        sblk = torch.einsum("bsgrh,btgh->bgrst", qg.to(torch.float32),
                            kblk.to(torch.float32))
        ok = kv_pos[None, :] <= q_positions[:, None]
        if window:
            ok &= kv_pos[None, :] > q_positions[:, None] - window
        sblk = sblk.masked_fill(~ok, -torch.inf)
        m_new = torch.maximum(m, torch.amax(sblk, dim=-1))
        # Rows with no valid key yet stay empty (exp(-inf - -inf) guards).
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sblk - safe_m[..., None]).masked_fill(~ok, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgh->bgrsh", p, vblk.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B, G, R, S, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype)


# Sequence length above which the quadratic core switches to the flash
# formulation (the [S, T] score tensor stops fitting device memory).
FLASH_THRESHOLD = 4096


def _self_attention_core(q, k, v, *, positions, window, s, scale):
    if s > FLASH_THRESHOLD:
        return _flash_core(q, k, v, q_positions=positions, window=window,
                           scale=scale)
    mask = causal_mask(s, s, window=window, device=q.device)
    return _gqa_core(q, k, v, mask[None, None, None], scale)


def causal_mask(s: int, t: int, *, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[S, T] bool; query i attends key j iff j <= i+offset (and within
    the sliding window when window > 0)."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m


def _out_proj(params, out, cfg, policy, generator=None):
    b, s = out.shape[:2]
    en = policy.apply_to_attn_proj if policy else False
    return common.linear_apply(params["wo"], out.reshape(b, s, cfg.q_dim),
                               policy, cim_enabled=en, generator=generator)


def attend_full(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B, S]
    window: int = 0,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Training / prefill self-attention (no cache); ``generator`` feeds
    a noisy operating point's projections."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, policy, generator)
    q = constrain_query(common.apply_rope(q, positions, cfg.rope_theta))
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = _self_attention_core(q, k, v, positions=positions[0],
                               window=window, s=s, scale=cfg.attn_scale)
    return _out_proj(params, out, cfg, policy, generator)


def prefill_cache(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: KVCache,
    *,
    positions: torch.Tensor,
    window: int = 0,
    policy: CIMPolicy | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill: run full attention and write the prompt's K/V into the
    cache (in place)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, policy)
    q = constrain_query(common.apply_rope(q, positions, cfg.rope_theta))
    k = common.apply_rope(k, positions, cfg.rope_theta)
    c = cache.k.shape[1]
    kc = to_cache_dtype(k, cache.k.dtype)  # the cache may be fp8
    vc = to_cache_dtype(v, cache.v.dtype)
    if window and c == window:
        # Keep the last `window` tokens, slot = pos % window.
        take = min(s, window)
        idx = (positions[:, -take:] % window).long()
        bidx = torch.arange(b, device=x.device)[:, None]
        cache.k[bidx, idx] = kc[:, -take:]
        cache.v[bidx, idx] = vc[:, -take:]
    else:
        cache.k[:, :s] = kc
        cache.v[:, :s] = vc
    out = _self_attention_core(q, k, v, positions=positions[0],
                               window=window, s=s, scale=cfg.attn_scale)
    return _out_proj(params, out, cfg, policy), cache


def as_position(pos: int | torch.Tensor, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a Python int
    is filled in on the device (a kernel, not a copy from the host), a
    tensor is taken as it is."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((), pos, dtype=torch.long, device=device)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                row: torch.Tensor) -> None:
    """``cache[:, slot] = row`` at a 0-d device index, with no read of it
    on the host; float8 rows are copied as bytes (``index_copy_`` takes
    no float8)."""
    if cache.element_size() == 1:
        cache, row = cache.view(torch.uint8), row.view(torch.uint8)
    cache.index_copy_(1, slot.view(1), row[:, None])


def decode_step(
    params: dict,
    x: torch.Tensor,  # [B, 1, D]
    cfg: ModelConfig,
    cache: KVCache,
    pos: int | torch.Tensor,  # position of the new token
    *,
    window: int = 0,
    policy: CIMPolicy | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step against the cache (full or ring), written in
    place. ``pos`` is a Python int or a 0-d integer tensor on x's device;
    the step reads it only on the device, so the same step runs captured
    in a CUDA graph with the position in a buffer."""
    b = x.shape[0]
    pos = as_position(pos, x.device)
    positions = pos.view(1, 1).expand(b, 1)
    q, k, v = _project_qkv(params, x, cfg, policy)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)

    c = cache.k.shape[1]
    slots = torch.arange(c, device=x.device)
    if window and c == window:
        slot = torch.remainder(pos, window)
        # Slots 0..pos are valid until the ring wraps; afterwards every
        # slot holds one of the last `window` tokens.
        valid = (slots <= pos) | (pos >= c - 1)
    else:
        slot = torch.clamp(pos, max=c - 1)  # the JAX package's update clamps
        valid = slots <= pos
    _write_slot(cache.k, slot, to_cache_dtype(k[:, 0], cache.k.dtype))
    _write_slot(cache.v, slot, to_cache_dtype(v[:, 0], cache.v.dtype))
    out = _gqa_core(q, cache.k, cache.v, valid[None, None, None, None, :],
                    cfg.attn_scale)
    return _out_proj(params, out, cfg, policy), cache


def cross_attend(
    params: dict,
    x: torch.Tensor,  # [B, S, D] decoder states
    memory_kv: tuple[torch.Tensor, torch.Tensor],  # encode_memory_kv's
    cfg: ModelConfig,
    *,
    policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Encoder-decoder cross attention against precomputed memory K/V:
    no RoPE, no mask."""
    b, s, _ = x.shape
    en = policy.apply_to_attn_proj if policy else False
    q = common.linear_apply(params["wq"], x, policy, cim_enabled=en,
                            generator=generator)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = memory_kv
    return _out_proj(params, _gqa_core(q, k, v, None, cfg.attn_scale), cfg,
                     policy, generator)


def encode_memory_kv(
    params: dict, memory: torch.Tensor, cfg: ModelConfig,
    *, policy: CIMPolicy | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, T, KVH, hd] from the encoder output
    [B, T, D]."""
    b, t, _ = memory.shape
    en = policy.apply_to_attn_proj if policy else False
    k, v = (common.linear_apply(params[n], memory, policy, cim_enabled=en,
                                generator=generator) for n in ("wk", "wv"))
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))
