"""The granite_moe family's cell: granite-3.0-1b-a400m served by the
program's ``ServeEngine(plan=True)`` and its ``generate`` (greedy), call
after call over a pool of seeded prompts; every MoE layer routes each
token to its top k experts, which run through the macro on their own
tokens only (``MoEConfig.dispatch='ragged'``).

Traffic parameters as ``adapters/lm.py``'s; the calls, the check
(``token_gap`` against ``reference/granite_moe.py``, teacher-forced) and
the control are that family's.
"""

from __future__ import annotations

import torch

from perfbench import generate
from perfbench.adapters import lm
from perfbench.reference import granite_moe


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The raw weights from ``seed`` on the device, in the configuration's
    dtype: one draw per kind of leaf, stacked over the layers ([L, K, N]
    for an attention projection, [L, E, K, N] for an expert bank), so 13
    draws in all. Linear weights at a fan-in scale, the router and the
    table at 0.02, norm scales near 1."""
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(
        generate.sub_seed(seed, 20))
    n_layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    n_experts = cfg["num_local_experts"]
    pad = cfg["vocab_pad_to"]
    vocab_pad = -(-cfg["vocab_size"] // pad) * pad

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return (t * std + mean).to(dtype)

    w = {"table": draw((vocab_pad, d), 0.02),
         "final_norm": draw((d,), 0.05, 1.0),
         "norm1": draw((n_layers, d), 0.05, 1.0),
         "norm2": draw((n_layers, d), 0.05, 1.0),
         "router": draw((n_layers, d, n_experts), 0.02)}
    for name, k, n in granite_moe.attention_shapes(cfg):
        w[name] = draw((n_layers, k, n), k ** -0.5)
    for name, k, n in granite_moe.expert_shapes(cfg):
        w[name] = draw((n_layers, n_experts, k, n), k ** -0.5)
    return w


def program_params(w: dict) -> dict:
    """The raw weights in the program's tree (views, no copy)."""
    layer = {"norm1": {"scale": w["norm1"]},
             "attn": {name: {"w": w[name]}
                      for name in granite_moe.ATTENTION},
             "norm2": {"scale": w["norm2"]},
             "moe": {"router": {"w": w["router"]}, "gate": w["gate"],
                     "up": w["up"], "down": w["down"]}}
    return {"embed": {"table": w["table"]},
            "final_norm": {"scale": w["final_norm"]},
            "units": {"layer_00": layer}}


def reference_weights(w: dict) -> dict:
    """The raw weights in the reference's tree (views, no copy)."""
    return {"embed": {"table": w["table"]}, "final_norm": w["final_norm"],
            "layers": [{k: v[i] for k, v in w.items()
                        if k not in ("table", "final_norm")}
                       for i in range(w["norm1"].shape[0])]}


def program_config(cfg: dict):
    """The program's ModelConfig from the file's numbers: the LM family's
    with the MoE layer and Granite's multipliers."""
    from repro_torch.configs.base import MoEConfig

    dense = lm.program_config(dict(cfg, qkv_bias=cfg["attention_bias"],
                                   max_seq_len=cfg["max_position_embeddings"]))
    return dense.replace(
        family="moe",
        moe=MoEConfig(n_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_expert=cfg["intermediate_size"],
                      dispatch=cfg["dispatch"]),
        embedding_multiplier=cfg["embedding_multiplier"],
        attention_multiplier=cfg["attention_multiplier"],
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=cfg["logits_scaling"])


def model_macs(cfg: dict, traffic: dict) -> int:
    """Multiply-accumulates one call needs (the routed experts only)."""
    return sum(granite_moe.pass_macs(cfg, traffic["batch"], start, length)
               for start, length in lm.passes(traffic))


def macro_products(cfg: dict, traffic: dict) -> list[dict]:
    """The macro matmuls of one call, counted from the work and not from
    how the program runs it: per pass and layer, the four attention
    projections at M = batch x length, and one product for each
    projection of each of the E experts at M = batch x length x k / E,
    with every expert's weights counted once. The sum of the experts'
    MACs is the routed MACs exactly; the bytes are an upper bound (an
    expert no token reaches reads no weights)."""
    out_bytes = torch.finfo(getattr(torch, cfg["activation_dtype"])).bits // 8
    n_experts = cfg["num_local_experts"]
    share = cfg["num_experts_per_tok"] / n_experts
    prods = []
    for _, length in lm.passes(traffic):
        m = traffic["batch"] * length
        layer = [dict(m=m, k=k, n=n, in_elems=m * k, out_bytes=out_bytes)
                 for _, k, n in granite_moe.attention_shapes(cfg)]
        layer += [dict(m=m * share, k=k, n=n, in_elems=m * share * k,
                       out_bytes=out_bytes)
                  for _, k, n in granite_moe.expert_shapes(cfg)] * n_experts
        prods += layer * cfg["num_hidden_layers"]
    return prods


class Cell(lm.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, stages):
        from repro_torch.serve.engine import ServeEngine

        pcfg = program_config(cfg)  # first: a program without it stops here
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.batch = traffic["batch"]
        self.prompt_len = traffic["prompt_len"]
        self.new_tokens = traffic["new_tokens"]
        self.pool_n = traffic["pool"]
        self.per_call = self.batch * (self.new_tokens
                                      if traffic["units"] == "generated"
                                      else self.prompt_len)
        self.steps_per_call = self.new_tokens
        # Expert slots of one pass: what expert_share counts spans against.
        self.expert_slots = cfg["num_hidden_layers"] * cfg["num_local_experts"]
        with stages("weights"):
            self.weights = make_weights(cfg, seed, device)
        with stages("plan"):
            params = program_params(self.weights)
            lm._check_tree(params, pcfg)
            self.engine = ServeEngine(params, pcfg, max_len=traffic["max_len"],
                                      batch=self.batch, plan=True,
                                      device=device)
        with stages("inputs"):
            self.prompts = generate.lm_prompts(
                cfg["vocab_size"], self.batch, self.prompt_len, self.pool_n,
                seed, device)
        self.tokens = []
        with stages("warmup"):
            for i in range(traffic["warmup"]):
                self.call(i)
            self.tokens.clear()

    def model_macs(self) -> int:
        return model_macs(self.cfg, self.traffic)

    def macro_products(self) -> list[dict]:
        return macro_products(self.cfg, self.traffic)

    def _reference(self, act_dtype=None):
        return granite_moe.GraniteMoe(reference_weights(self.weights),
                                      self.cfg, act_dtype=act_dtype)
