"""The LM family's cell: the program's ``ServeEngine(plan=True)`` and its
``generate`` (greedy), call after call over a pool of seeded prompts.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``prompt_len``,
``new_tokens`` (``generate``'s n_tokens), ``max_len`` (the engine's
cache length), ``pool`` (distinct prompt batches, cycled), ``warmup``
(calls before the window) and ``units``: "generated" counts
batch * new_tokens a call, "prompt" batch * prompt_len. One call makes a
prefill and new_tokens - 1 decode steps.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import generate
from perfbench.reference import qwen2

def make_weights(cfg: dict, seed: int, device) -> dict:
    """The raw weights from ``seed`` on the device, in the configuration's
    dtype: one draw per kind of leaf, stacked over the layers ([L, K, N]
    for a projection), so 14 draws in all. Linear weights at a fan-in
    scale, the table at 0.02, biases at 0.02, norm scales near 1."""
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(
        generate.sub_seed(seed, 20))
    n_layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    pad = cfg["vocab_pad_to"]
    vocab_pad = -(-cfg["vocab_size"] // pad) * pad

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return (t * std + mean).to(dtype)

    w = {"table": draw((vocab_pad, d), 0.02),
         "final_norm": draw((d,), 0.05, 1.0),
         "norm1": draw((n_layers, d), 0.05, 1.0),
         "norm2": draw((n_layers, d), 0.05, 1.0)}
    for name, k, n in qwen2.projection_shapes(cfg):
        w[name] = draw((n_layers, k, n), k ** -0.5)
        if name in ("wq", "wk", "wv") and cfg["qkv_bias"]:
            w["b" + name[1:]] = draw((n_layers, n), 0.02)
    return w


def program_params(w: dict) -> dict:
    """The raw weights in the program's tree (views, no copy)."""
    attn = {name: {"w": w[name]} for name in ("wq", "wk", "wv", "wo")}
    for name in ("wq", "wk", "wv"):
        if "b" + name[1:] in w:
            attn[name]["b"] = w["b" + name[1:]]
    layer = {"norm1": {"scale": w["norm1"]}, "attn": attn,
             "norm2": {"scale": w["norm2"]},
             "mlp": {name: {"w": w[name]} for name in ("gate", "up", "down")}}
    return {"embed": {"table": w["table"]},
            "final_norm": {"scale": w["final_norm"]},
            "units": {"layer_00": layer}}


def reference_weights(w: dict) -> dict:
    """The raw weights in the reference's tree (views, no copy)."""
    layers = []
    for i in range(w["norm1"].shape[0]):
        layers.append({k: v[i] for k, v in w.items()
                       if k not in ("table", "final_norm")})
    return {"embed": {"table": w["table"]}, "final_norm": w["final_norm"],
            "layers": layers}


def program_config(cfg: dict):
    """The program's ModelConfig from the file's numbers."""
    from repro_torch.configs.base import CIMPolicy, ModelConfig
    from repro_torch.core.params import CIMConfig

    c = cfg["cim"]
    policy = CIMPolicy(
        mode=cfg["mode"],
        cim=CIMConfig(rows_active=c["rows_active"], act_bits=c["act_bits"],
                      weight_bits=c["weight_bits"], adc_bits=c["adc_bits"],
                      cutoff=c["cutoff"], adc_mode=c["adc_mode"],
                      vdd=c["vdd"], noisy=c["noisy"]),
        act_symmetric=cfg["act_symmetric"],
        act_clip_pct=cfg["act_clip_pct"],
        apply_to_logits=cfg["apply_to_logits"],
    )
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        vocab_pad_to=cfg["vocab_pad_to"], qkv_bias=cfg["qkv_bias"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        max_seq_len=cfg["max_seq_len"], param_dtype=cfg["torch_dtype"],
        activation_dtype=cfg["activation_dtype"],
        kv_cache_dtype=cfg["activation_dtype"], cim=policy,
    )


def _check_tree(params: dict, cfg) -> None:
    """The tree has the program's names and shapes for this config."""
    from repro_torch.models import transformer

    def walk(got, want, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"weights at {path or '/'}: keys "
                                 f"{sorted(got)} != {sorted(want)}")
            for k in want:
                walk(got[k], want[k], f"{path}/{k}")
        elif tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"weights at {path}: {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")

    walk(params, transformer.abstract_params(cfg), "")


def passes(traffic: dict) -> list[tuple[int, int]]:
    """(start, length) of each pass of one call: the prefill, then a
    decode step per new token but the first."""
    s = traffic["prompt_len"]
    return [(0, s)] + [(s + j, 1) for j in range(traffic["new_tokens"] - 1)]


def model_macs(cfg: dict, traffic: dict) -> int:
    """Multiply-accumulates one call needs."""
    return sum(qwen2.pass_macs(cfg, traffic["batch"], start, length)
               for start, length in passes(traffic))


def macro_products(cfg: dict, traffic: dict) -> list[dict]:
    """The macro matmuls of one call: every projection of every layer in
    every pass, with the output's bytes per element."""
    out_bytes = torch.finfo(getattr(torch, cfg["activation_dtype"])).bits // 8
    prods = []
    for _, length in passes(traffic):
        m = traffic["batch"] * length
        for _, k, n in qwen2.projection_shapes(cfg):
            prods += [dict(m=m, k=k, n=n, in_elems=m * k,
                           out_bytes=out_bytes)] * cfg["num_hidden_layers"]
    return prods


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, stages):
        from repro_torch.serve.engine import ServeEngine

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.batch = traffic["batch"]
        self.prompt_len = traffic["prompt_len"]
        self.new_tokens = traffic["new_tokens"]
        self.pool_n = traffic["pool"]
        self.per_call = self.batch * (self.new_tokens
                                      if traffic["units"] == "generated"
                                      else self.prompt_len)
        self.steps_per_call = self.new_tokens
        with stages("weights"):
            self.weights = make_weights(cfg, seed, device)
        with stages("plan"):
            pcfg = program_config(cfg)
            params = program_params(self.weights)
            _check_tree(params, pcfg)
            self.engine = ServeEngine(params, pcfg, max_len=traffic["max_len"],
                                      batch=self.batch, plan=True,
                                      device=device)
        with stages("inputs"):
            self.prompts = generate.lm_prompts(
                cfg["vocab_size"], self.batch, self.prompt_len, self.pool_n,
                seed, device)
        self.tokens: list[np.ndarray] = []
        with stages("warmup"):
            for i in range(traffic["warmup"]):
                self.call(i)
            self.tokens.clear()

    def call(self, i: int) -> int:
        self.tokens.append(self.engine.generate(self.prompts[i % self.pool_n],
                                                self.new_tokens))
        return self.per_call

    # -- what one call does, for the per-layer metrics ----------------------

    def model_macs(self) -> int:
        return model_macs(self.cfg, self.traffic)

    def macro_products(self) -> list[dict]:
        return macro_products(self.cfg, self.traffic)

    # -- the check -----------------------------------------------------------

    def release(self) -> None:
        self.engine = None

    def _reference(self, act_dtype=None):
        return qwen2.Qwen2(reference_weights(self.weights), self.cfg,
                           act_dtype=act_dtype)

    def _served(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.tokens[i]).long().to(self.device)

    def compare(self, picks: list[int], outputs=None) -> dict:
        """``token_gap``: the widest gap, over every token the picked calls
        served, between the reference's best logit and its logit of the
        served token, the reference teacher-forced on the served tokens.
        ``outputs`` (call -> tokens) puts other tokens in the program's
        place (the control)."""
        ref = self._reference()
        worst = 0.0
        for i in picks:
            served = self._served(i)
            logits = ref.serve(self.prompts[i % self.pool_n], served)
            toks = served if outputs is None else outputs[i]
            gap = logits.amax(-1) - logits.gather(-1, toks[..., None])[..., 0]
            worst = max(worst, float(gap.max()))
        return {"token_gap": worst}

    def control_outputs(self, picks: list[int]) -> dict:
        """At each position of the served tokens, the token that the
        reference in float8 e4m3 activations puts first."""
        ref = self._reference(act_dtype=torch.float8_e4m3fn)
        return {i: ref.serve(self.prompts[i % self.pool_n],
                             self._served(i)).argmax(-1) for i in picks}
