"""The LM stack: one config-driven decoder over the CIM engine.

A model is a repeating *pattern unit* of layers (gemma3: 5 local + 1
global; jamba: 1 attn + 7 mamba with MoE on every 2nd layer; rwkv: one
rwkv layer; dense: one attn layer). Units with identical structure are
stacked under ``params["units"]`` (every leaf gains a leading [U] dim,
as the JAX package stacks them for ``lax.scan``); the non-multiple
remainder runs unrolled as ``tail_XX`` layers. Here the scan is a Python
loop over the stacked index: each unit's parameters are views of the
stacked tensors (``PlannedWeights.layer`` for plans) and its caches are
views of the stacked caches. KV caches are written in place; a recurrent
state (mamba, rwkv) is copied back into its stacked cache after each
prefill and decode step, rounded to the cache's dtype as the JAX
package's scan carry is, while a tail layer keeps the state it returns.

Entry points:
  init(seed, cfg, device=)              -> params
  forward_train(params, batch, cfg)     -> logits, MoE aux
  loss_fn(params, batch, cfg)           -> scalar loss, metrics
  init_caches / prefill / decode_step   -> the serving path
The encoder-decoder (whisper) adds ``encode`` and cross-attention in the
decoder (``memory=`` in prefill and decode_step); the modality frontends
are embedding stubs (``batch["frontend_embeds"]`` is prepended to the
text in ``forward_train``; serving is text only, as in the JAX package).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import CIMPolicy, ModelConfig
from repro_torch.core.engine import PlannedWeights
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, common, mamba, moe, rwkv
from repro_torch.models.attention import KVCache
from repro_torch.models.common import ParamSpec

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ModelConfig, layer_idx: int, *, cross: bool = False
                ) -> dict:
    kind = cfg.layer_kind(layer_idx)
    spec: dict = {"norm1": common.rmsnorm_spec(cfg.d_model)}
    if kind in ("attn", "attn_local"):
        spec["attn"] = attention.attn_spec(cfg)
    elif kind == "mamba":
        spec["mamba"] = mamba.mamba_spec(cfg)
    else:  # rwkv
        spec["tm"] = rwkv.rwkv_spec(cfg)
    if cross:
        spec["norm_x"] = common.rmsnorm_spec(cfg.d_model)
        spec["xattn"] = attention.attn_spec(cfg)
    spec["norm2"] = common.rmsnorm_spec(cfg.d_model)
    if kind == "rwkv":
        spec["cm"] = rwkv.channelmix_spec(cfg)
    elif cfg.layer_uses_moe(layer_idx):
        spec["moe"] = moe.moe_spec(cfg)
    else:
        spec["mlp"] = common.mlp_spec(cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return spec


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's layers: self-attention and the dense MLP."""
    return cfg.replace(is_encoder_decoder=False, layer_pattern=("attn",),
                       moe=None)


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
        unit = {f"layer_{j:02d}": _layer_spec(cfg, j, cross=cross)
                for j in range(p)}
        spec["units"] = _stack_spec(unit, n_units)
    for t in range(n_tail):
        spec[f"tail_{t:02d}"] = _layer_spec(cfg, n_units * p + t,
                                            cross=cross)
    if cross:
        spec["encoder"] = {f"enc_{j:02d}": _layer_spec(_encoder_cfg(cfg), j)
                           for j in range(cfg.n_encoder_layers)}
        spec["enc_norm"] = common.rmsnorm_spec(cfg.d_model)
    if cfg.learned_pos_emb:
        spec["pos_emb"] = ParamSpec((cfg.max_seq_len, cfg.d_model),
                                    (None, "embed"), "normal:0.01")
    return spec


def model_axes(cfg: ModelConfig) -> Any:
    """The logical axes of every parameter (``model_spec``'s tree)."""
    return common.logical_axes(model_spec(cfg))


def init(seed: int, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random parameters at ``cfg``'s widths, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = common.init_params(gen, model_spec(cfg),
                                dtype=getattr(torch, cfg.param_dtype))
    return _apply_special_inits(params, cfg)


def abstract_params(cfg: ModelConfig) -> Params:
    """``init``'s tree as meta tensors: its names, shapes and dtypes, no
    weight drawn (the JAX package's ``jax.eval_shape`` over init)."""
    dtype = getattr(torch, cfg.param_dtype)

    def meta(spec):
        if isinstance(spec, ParamSpec):
            return torch.empty(spec.shape, dtype=dtype, device="meta")
        return {k: meta(v) for k, v in spec.items()}

    return meta(model_spec(cfg))


def _apply_special_inits(params: Params, cfg: ModelConfig) -> Params:
    """S4D-real init of every mamba ``a_log`` leaf, stacked or not:
    log(1..d_state) along the last axis."""
    if cfg.mamba is None:
        return params

    def fix(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fix(v)
            elif k == "a_log":
                base = torch.log(torch.arange(
                    1, cfg.mamba.d_state + 1, dtype=torch.float32,
                    device=v.device))
                out[k] = base.expand(v.shape).to(v.dtype).clone()
            else:
                out[k] = v
        return out

    return fix(params)


def _unit(tree: Any, u: int) -> Any:
    """Slice ``u`` of every leaf of a stacked params or caches tree (views:
    writes land in the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    if isinstance(tree, PlannedWeights):
        return tree.layer(u)
    if isinstance(tree, tuple):  # KVCache, MambaCache, RWKVCache
        return type(tree)(*(c[u] for c in tree))
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
        return _unit(caches["units"][path[2]], path[1])
    return caches[path[0]]


def _put_cache(caches, path, cache) -> None:
    """Store a layer's new cache: a recurrent state is copied into its
    stacked cache, rounded to that cache's dtype (the JAX package casts
    its scan carry back), or replaces a tail layer's (which keeps the
    dtypes the layer returned). KV caches were written in place."""
    if isinstance(cache, KVCache):
        return
    if path[0] == "units":
        for stacked, new in zip(caches["units"][path[2]], cache,
                                strict=True):
            stacked[path[1]].copy_(new)
    else:
        caches[path[0]] = cache


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


def _layer(lp, x, cfg: ModelConfig, li: int, *, policy, positions=None,
           cache=None, pos: int | None = None, mkv=None, generator=None):
    """One decoder layer: the full forward (``cache`` None), the prefill
    (a cache, ``pos`` None) or one decode step at ``pos``. Returns (x, the
    layer's new cache or None, its MoE aux loss or None). ``generator``
    feeds a noisy operating point and the router's jitter."""
    kind = cfg.layer_kind(li)
    decode = pos is not None
    h = common.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
    if kind in ("attn", "attn_local"):
        window = _window(cfg, li)
        if cache is None:
            a = attention.attend_full(lp["attn"], h, cfg, positions=positions,
                                      window=window, policy=policy,
                                      generator=generator)
        elif not decode:
            a, cache = attention.prefill_cache(
                lp["attn"], h, cfg, cache, positions=positions,
                window=window, policy=policy)
        else:
            a, cache = attention.decode_step(lp["attn"], h, cfg, cache, pos,
                                             window=window, policy=policy)
    elif kind == "mamba":
        if cache is None:
            a = mamba.mamba_apply(lp["mamba"], h, cfg, policy=policy,
                                  generator=generator)
        elif not decode:
            a, mc = mamba.mamba_apply(lp["mamba"], h, cfg, policy=policy,
                                      return_cache=True)
            cache = mamba.MambaCache(*(n.to(o.dtype)
                                       for o, n in zip(cache, mc)))
        else:
            a, cache = mamba.mamba_decode_step(lp["mamba"], h, cfg, cache,
                                               policy=policy)
    else:  # rwkv; a decode step is the one-token scan (chunk 1)
        if decode:
            h = h.to(cache.shift_tm.dtype)
        a, s_tm, state = rwkv.timemix_apply(
            lp["tm"], h, cfg, shift_state=cache.shift_tm if decode else None,
            wkv_state=None if cache is None else cache.state,
            chunk=1 if decode else 128, policy=policy, generator=generator)
        if cache is not None:
            cache = cache._replace(shift_tm=s_tm.to(cache.shift_tm.dtype),
                                   state=state.to(cache.state.dtype))
    x = x + a.to(x.dtype)
    if mkv is not None:
        hx = common.rmsnorm_apply(lp["norm_x"], x, cfg.norm_eps)
        x = x + attention.cross_attend(lp["xattn"], hx, mkv, cfg,
                                       policy=policy, generator=generator)
    h = common.rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    aux = None
    if kind == "rwkv":
        if decode:
            h = h.to(cache.shift_cm.dtype)
        m, s_cm = rwkv.channelmix_apply(
            lp["cm"], h, cfg, shift_state=cache.shift_cm if decode else None,
            policy=policy, generator=generator)
        if cache is not None:
            cache = cache._replace(shift_cm=s_cm.to(cache.shift_cm.dtype))
    elif "moe" in lp:
        m, metrics = moe.moe_apply(lp["moe"], h, cfg, policy=policy,
                                   generator=generator)
        aux = metrics.aux_loss
    else:
        m = common.mlp_apply(lp["mlp"], h, cfg.mlp_act, policy,
                             generator=generator)
    return x + m.to(x.dtype), cache, aux


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
    return constrain(logits, ("act_batch", "act_seq", "act_vocab"))


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
        h = common.rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
        x = x + common.mlp_apply(lp["mlp"], h, cfg.mlp_act, policy).to(
            x.dtype)
    return common.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _layer_seeds(generator, cfg: ModelConfig) -> list[int | None]:
    """One seed per layer, drawn from the step's generator (None without
    one). A layer builds its generator from its seed each time it runs,
    so a recomputed (remat) layer draws the same noise."""
    if generator is None:
        return [None] * cfg.n_layers
    seeds = torch.randint(0, 2**62, (cfg.n_layers,), generator=generator,
                          device=generator.device)
    return seeds.tolist()


def forward_train(
    params: Params, batch: dict, cfg: ModelConfig, *,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward over ``batch["tokens"]`` [B, S], after
    ``batch["frontend_embeds"]`` [B, F, D] where the config has a frontend
    (the logits then cover F + S positions), with cross-attention to
    ``encode(batch["encoder_frames"])`` in an encoder-decoder; returns
    (logits, the MoE aux losses summed over layers).

    Differentiable: fresh (unplanned) weights run through
    ``engine.matmul``, whose backward is the straight-through estimator.
    ``generator`` (the step's) gives each layer its own generator, as the
    JAX package folds the layer index into its key; the streams differ
    from ``jax.random``'s. ``cfg.remat`` other than "none" recomputes each
    layer in the backward (``torch.utils.checkpoint``, non-reentrant):
    the same numbers, a forward's launches again."""
    policy = cfg.cim
    x = _embed(params, batch["tokens"], cfg)
    if cfg.frontend and "frontend_embeds" in batch:
        x = torch.cat([batch["frontend_embeds"].to(x.dtype), x], dim=1)
    x = constrain(_add_pos(params, x, cfg),
                  ("act_batch", "act_seq", "act_embed"))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, batch["encoder_frames"], cfg, policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds = _layer_seeds(generator, cfg)
    for (li, lp, path), seed in zip(_layers(params, cfg), seeds, strict=True):
        mkv = _memory_kv(lp, memory, cfg, policy)

        def one(x, lp=lp, li=li, mkv=mkv, seed=seed):
            gen = None if seed is None else torch.Generator(
                device=x.device).manual_seed(seed)
            y, _, a = _layer(lp, x, cfg, li, policy=policy,
                             positions=positions, mkv=mkv, generator=gen)
            return y, a

        if cfg.remat != "none" and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(one, x,
                                                     use_reentrant=False)
        else:
            x, a = one(x)
        if a is not None:
            aux = aux + a
    return _logits(params, x, cfg, policy), aux


def loss_fn(
    params: Params, batch: dict, cfg: ModelConfig, *,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy over the labels >= 0 (a negative label is
    masked out), in float32, plus the MoE aux loss at its weight; the
    frontend positions carry no loss. Returns (loss, metrics)."""
    logits, aux = forward_train(params, batch, cfg, generator=generator)
    labels = batch["labels"].long()
    if cfg.frontend and "frontend_embeds" in batch:
        logits = logits[:, batch["frontend_embeds"].shape[1]:]
    logits = constrain(logits.to(torch.float32),
                       ("act_batch", "act_seq", "act_vocab"))
    logp = torch.log_softmax(logits, dim=-1)
    # A negative label indexes from the end, as jnp.take_along_axis does;
    # its term is masked.
    idx = torch.where(labels < 0, labels + logp.shape[-1], labels)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    total = loss + aux_w * aux
    return total, {"ce_loss": loss, "moe_aux": aux, "tokens": torch.sum(mask)}


# ---------------------------------------------------------------------------
# Serving path: caches, prefill, decode
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ModelConfig, li: int, batch: int, max_len: int,
                 dtype, device):
    kind = cfg.layer_kind(li)
    if kind == "mamba":
        return mamba.init_cache(cfg, batch, dtype=dtype, device=device)
    if kind == "rwkv":
        return rwkv.init_cache(cfg, batch, dtype=dtype, device=device)
    # A kv_cache_dtype other than bfloat16 (float8_e4m3fn) overrides dtype
    # for KV caches; recurrent states keep the caller's dtype.
    if cfg.kv_cache_dtype != "bfloat16":
        dtype = getattr(torch, cfg.kv_cache_dtype)
    return attention.init_cache(cfg, batch, max_len, window=_window(cfg, li),
                                dtype=dtype, device=device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Every layer's cache (KVCache, MambaCache or RWKVCache): ``units``
    (stacked [U, ...] per pattern layer) and ``tail_XX``."""
    p, n_units, n_tail = _unit_split(cfg)
    caches: dict = {}
    if n_units:
        caches["units"] = {}
        for j in range(p):
            one = _layer_cache(cfg, j, batch, max_len, dtype, device)
            caches["units"][f"layer_{j:02d}"] = type(one)(
                *(torch.zeros((n_units,) + c.shape, dtype=c.dtype,
                              device=c.device) for c in one))
    for t in range(n_tail):
        caches[f"tail_{t:02d}"] = _layer_cache(cfg, n_units * p + t, batch,
                                               max_len, dtype, device)
    return caches


def prefill(
    params: Params, tokens: torch.Tensor, caches: dict, cfg: ModelConfig,
    *, memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt [B, S] (cross-attending to the encoder output
    ``memory`` [B, T, D], whose K/V each layer projects anew); returns
    (last-position logits [B, V], caches), the caches updated in place."""
    policy = cfg.cim
    x = _add_pos(params, _embed(params, tokens, cfg), cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for li, lp, path in _layers(params, cfg):
        x, cache, _ = _layer(lp, x, cfg, li, policy=policy,
                             positions=positions,
                             cache=_cache_at(caches, path),
                             mkv=_memory_kv(lp, memory, cfg, policy))
        _put_cache(caches, path, cache)
    logits = _logits(params, x[:, -1:], cfg, policy)
    return logits[:, 0], caches


def decode_step(
    params: Params, token: torch.Tensor, pos: int, caches: dict,
    cfg: ModelConfig, *, memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """One serving step: the token [B] at position ``pos`` -> next-token
    logits [B, V], the caches updated in place. With ``memory`` (the
    encoder output) every layer projects its cross-attention K/V anew in
    each step, as the JAX package does."""
    policy = cfg.cim
    x = _add_pos(params, _embed(params, token[:, None], cfg), cfg, pos)
    for li, lp, path in _layers(params, cfg):
        x, cache, _ = _layer(lp, x, cfg, li, policy=policy,
                             cache=_cache_at(caches, path), pos=pos,
                             mkv=_memory_kv(lp, memory, cfg, policy))
        _put_cache(caches, path, cache)
    return _logits(params, x, cfg, policy)[:, 0], caches
