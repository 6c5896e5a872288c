"""The dense LM stack: one config-driven decoder over the CIM engine.

A model is a repeating *pattern unit* of layers (gemma3: 5 local + 1
global; dense: one attn layer). Units with identical structure are
stacked under ``params["units"]`` (every leaf gains a leading [U] dim,
as the JAX package stacks them for ``lax.scan``); the non-multiple
remainder runs unrolled as ``tail_XX`` layers. Here the scan is a Python
loop over the stacked index: each unit's parameters are views of the
stacked tensors (``PlannedWeights.layer`` for plans) and its KV caches
are views of the stacked caches, written in place.

Entry points:
  init(seed, cfg, device=)              -> params
  forward_train(params, batch, cfg)     -> logits, aux (forward only)
  init_caches / prefill / decode_step   -> the serving path
The encoder-decoder (whisper) adds ``encode`` and cross-attention in the
decoder (``memory=`` in prefill and decode_step); the modality frontends
are embedding stubs (``batch["frontend_embeds"]`` is prepended to the
text in ``forward_train``; serving is text only, as in the JAX package).

Layer kinds mamba and rwkv and MoE MLPs are not ported yet and raise,
naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import CIMPolicy, ModelConfig
from repro_torch.core.engine import PlannedWeights
from repro_torch.models import attention, common
from repro_torch.models.attention import KVCache
from repro_torch.models.common import ParamSpec

Params = dict[str, Any]


def _check_ported(cfg: ModelConfig) -> None:
    missing = []
    if cfg.moe is not None:
        missing.append("MoE MLPs (slice 6, A11)")
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if kinds - {"attn", "attn_local"}:
        missing.append(f"{sorted(kinds - {'attn', 'attn_local'})} layers "
                       "(slice 6, A11)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(missing)} of "
            "ROADMAP.md")


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ModelConfig, *, cross: bool = False) -> dict:
    spec = {"norm1": common.rmsnorm_spec(cfg.d_model),
            "attn": attention.attn_spec(cfg)}
    if cross:
        spec["norm_x"] = common.rmsnorm_spec(cfg.d_model)
        spec["xattn"] = attention.attn_spec(cfg)
    spec["norm2"] = common.rmsnorm_spec(cfg.d_model)
    spec["mlp"] = common.mlp_spec(cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return spec


def _stack_spec(spec: Any, n: int) -> Any:
    if isinstance(spec, ParamSpec):
        return ParamSpec((n,) + spec.shape, ("layers",) + spec.axes,
                         spec.init, spec.dtype)
    return {k: _stack_spec(v, n) for k, v in spec.items()}


def _unit_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """(pattern_len, n_stacked_units, n_tail_layers)."""
    p = cfg.pattern_len
    if not cfg.scan_layers:
        return p, 0, cfg.n_layers
    n_units = cfg.n_layers // p
    return p, n_units, cfg.n_layers - n_units * p


def model_spec(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    p, n_units, n_tail = _unit_split(cfg)
    cross = cfg.is_encoder_decoder
    spec: dict = {
        "embed": common.embedding_spec(cfg.padded_vocab, cfg.d_model),
        "final_norm": common.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = common.linear_spec(
            cfg.d_model, cfg.padded_vocab, "embed", "vocab"
        )
    if n_units:
        unit = {f"layer_{j:02d}": _layer_spec(cfg, cross=cross)
                for j in range(p)}
        spec["units"] = _stack_spec(unit, n_units)
    for t in range(n_tail):
        spec[f"tail_{t:02d}"] = _layer_spec(cfg, cross=cross)
    if cross:  # encoder layers: self-attention and the MLP
        spec["encoder"] = {f"enc_{j:02d}": _layer_spec(cfg)
                           for j in range(cfg.n_encoder_layers)}
        spec["enc_norm"] = common.rmsnorm_spec(cfg.d_model)
    if cfg.learned_pos_emb:
        spec["pos_emb"] = ParamSpec((cfg.max_seq_len, cfg.d_model),
                                    (None, "embed"), "normal:0.01")
    return spec


def init(seed: int, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random parameters at ``cfg``'s widths, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = common.init_params(gen, model_spec(cfg))
    return _map(lambda a: a.to(getattr(torch, cfg.param_dtype)), params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unit(tree: Any, u: int) -> Any:
    """Slice ``u`` of every leaf of a stacked params or caches tree (views:
    cache writes land in the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    if isinstance(tree, PlannedWeights):
        return tree.layer(u)
    if isinstance(tree, KVCache):
        return KVCache(tree.k[u], tree.v[u])
    return tree[u]


def _layers(params: Params, cfg: ModelConfig):
    """(layer_idx, layer params, cache key path) in execution order."""
    p, n_units, n_tail = _unit_split(cfg)
    for u in range(n_units):
        unit = _unit(params["units"], u)
        for j in range(p):
            yield j, unit[f"layer_{j:02d}"], ("units", u, f"layer_{j:02d}")
    for t in range(n_tail):
        li = n_units * p + t
        yield li, params[f"tail_{t:02d}"], (f"tail_{t:02d}",)


def _cache_at(caches, path):
    if path[0] == "units":
        return KVCache(*(c[path[1]] for c in caches["units"][path[2]]))
    return caches[path[0]]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _window(cfg: ModelConfig, layer_idx: int) -> int:
    return cfg.window_size if cfg.layer_kind(layer_idx) == "attn_local" else 0


def _memory_kv(lp, memory, cfg, policy):
    """A decoder layer's cross-attention K/V of the encoder output, or
    None (no memory, or no cross-attention in the layer)."""
    if memory is None or "xattn" not in lp:
        return None
    return attention.encode_memory_kv(lp["xattn"], memory, cfg,
                                      policy=policy)


def _mlp_residual(lp, x, cfg, policy, mkv=None):
    """The cross-attention residual against ``mkv`` (``_memory_kv``'s),
    when given, then the MLP residual."""
    if mkv is not None:
        hx = common.rmsnorm_apply(lp["norm_x"], x, cfg.norm_eps)
        x = x + attention.cross_attend(lp["xattn"], hx, mkv, cfg,
                                       policy=policy)
    h = common.rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    m = common.mlp_apply(lp["mlp"], h, cfg.mlp_act, policy)
    return x + m.to(x.dtype)


def _embed(params, tokens, cfg: ModelConfig):
    x = common.embedding_apply(params["embed"], tokens)
    return x.to(getattr(torch, cfg.activation_dtype))


def _add_pos(params, x, cfg: ModelConfig, start: int = 0):
    """Learned positions ``start .. start + S - 1`` added to x [B, S, D].
    A start past the table reads its last row, as the JAX package's
    ``dynamic_slice`` clamps."""
    if not cfg.learned_pos_emb:
        return x
    s = x.shape[1]
    start = min(max(start, 0), cfg.max_seq_len - s)
    return x + params["pos_emb"][start:start + s][None].to(x.dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _logits(params, x, cfg: ModelConfig, policy: CIMPolicy | None):
    h = common.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        table = params["embed"]["table"].to(h.dtype)
        logits = h @ table.T  # tied logits stay digital
    else:
        en = policy.apply_to_logits if policy else False
        logits = common.linear_apply(params["lm_head"], h, policy,
                                     cim_enabled=en)
    if cfg.padded_vocab != cfg.vocab_size:
        # Vocab-pad columns never win argmax nor enter the softmax mass.
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           policy: CIMPolicy | None = None) -> torch.Tensor:
    """The whisper-style encoder over precomputed frame embeddings
    [B, T, D] (stub frontend): bidirectional attention without RoPE,
    learned positions. Each layer's ``wo`` runs through the macro whatever
    ``policy.apply_to_attn_proj`` says, as in the JAX package."""
    x = _add_pos(params, frames.to(getattr(torch, cfg.activation_dtype)),
                 cfg)
    b, s, _ = x.shape
    for j in range(cfg.n_encoder_layers):
        lp = params["encoder"][f"enc_{j:02d}"]
        h = common.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        q, k, v = attention._project_qkv(lp["attn"], h, cfg, policy)
        a = attention._gqa_core(q, k, v, None)
        x = x + common.linear_apply(lp["attn"]["wo"],
                                    a.reshape(b, s, cfg.q_dim), policy)
        x = _mlp_residual(lp, x, cfg, policy)
    return common.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def forward_train(
    params: Params, batch: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward over ``batch["tokens"]`` [B, S], after
    ``batch["frontend_embeds"]`` [B, F, D] where the config has a frontend
    (the logits then cover F + S positions), with cross-attention to
    ``encode(batch["encoder_frames"])`` in an encoder-decoder; returns
    (logits, total MoE aux = 0). Forward only: training is slice 6."""
    policy = cfg.cim
    x = _embed(params, batch["tokens"], cfg)
    if cfg.frontend and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(x.dtype), x], dim=1)
    x = _add_pos(params, x, cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, batch["encoder_frames"], cfg, policy)
    for li, lp, _ in _layers(params, cfg):
        mkv = _memory_kv(lp, memory, cfg, policy)
        h = common.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        a = attention.attend_full(lp["attn"], h, cfg, positions=positions,
                                  window=_window(cfg, li), policy=policy)
        x = _mlp_residual(lp, x + a.to(x.dtype), cfg, policy, mkv)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg, policy), aux


# ---------------------------------------------------------------------------
# Serving path: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device="cuda") -> dict:
    """KV caches of every layer: ``units`` (stacked [U, ...] per pattern
    layer) and ``tail_XX``. A ``kv_cache_dtype`` other than bfloat16
    (float8_e4m3fn) overrides ``dtype``."""
    _check_ported(cfg)
    p, n_units, n_tail = _unit_split(cfg)
    if cfg.kv_cache_dtype != "bfloat16":
        dtype = getattr(torch, cfg.kv_cache_dtype)

    def layer_cache(li: int) -> KVCache:
        return attention.init_cache(cfg, batch, max_len,
                                    window=_window(cfg, li), dtype=dtype,
                                    device=device)

    caches: dict = {}
    if n_units:
        caches["units"] = {}
        for j in range(p):
            one = layer_cache(j)
            caches["units"][f"layer_{j:02d}"] = KVCache(
                *(torch.zeros((n_units,) + c.shape, dtype=c.dtype,
                              device=c.device) for c in one))
    for t in range(n_tail):
        caches[f"tail_{t:02d}"] = layer_cache(n_units * p + t)
    return caches


def prefill(
    params: Params, tokens: torch.Tensor, caches: dict, cfg: ModelConfig,
    *, memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt [B, S] (cross-attending to the encoder output
    ``memory`` [B, T, D], whose K/V each layer projects anew); returns
    (last-position logits [B, V], caches), the caches written in place."""
    policy = cfg.cim
    x = _add_pos(params, _embed(params, tokens, cfg), cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for li, lp, path in _layers(params, cfg):
        mkv = _memory_kv(lp, memory, cfg, policy)
        h = common.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        a, _ = attention.prefill_cache(
            lp["attn"], h, cfg, _cache_at(caches, path),
            positions=positions, window=_window(cfg, li), policy=policy)
        x = _mlp_residual(lp, x + a.to(x.dtype), cfg, policy, mkv)
    logits = _logits(params, x[:, -1:], cfg, policy)
    return logits[:, 0], caches


def decode_step(
    params: Params, token: torch.Tensor, pos: int, caches: dict,
    cfg: ModelConfig, *, memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One serving step: the token [B] at position ``pos`` -> next-token
    logits [B, V], the caches written in place. With ``memory`` (the
    encoder output) every layer projects its cross-attention K/V anew in
    each step, as the JAX package does."""
    policy = cfg.cim
    x = _add_pos(params, _embed(params, token[:, None], cfg), cfg, pos)
    for li, lp, path in _layers(params, cfg):
        mkv = _memory_kv(lp, memory, cfg, policy)
        h = common.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        a, _ = attention.decode_step(
            lp["attn"], h, cfg, _cache_at(caches, path), pos,
            window=_window(cfg, li), policy=policy)
        x = _mlp_residual(lp, x + a.to(x.dtype), cfg, policy, mkv)
    return _logits(params, x, cfg, policy)[:, 0], caches
