"""Granite 3.0 MoE (IBM's granite-3.0-1b-a400m; transformers'
``GraniteMoeForCausalLM``) in plain PyTorch, every projection through the
reference macro: the benchmark's yardstick for the granite cell.

A pre-norm decoder as ``qwen2.Qwen2`` is (RMSNorm, grouped-query attention
with RoPE on q and k, no biases, the head tied to the embedding table),
with a sparse MoE MLP on every layer and Granite's four multipliers, each
where HF applies it:

  x = embed(ids) * embedding_multiplier
  scores = q.k * attention_multiplier          (in place of 1/sqrt(hd))
  x = x + attn(norm1(x)) * residual_multiplier, the same for the MoE
  logits = head(norm(x)) / logits_scaling

The MoE layer: a bias-free d -> E router whose logits, in float32, give
the top k experts of each token and their weights, a softmax over those
k (cast to the activation dtype); each expert computes
down(silu(gate x) * up x) on the tokens routed to it and on no others, no
token dropped; each token adds its k weighted outputs.

Departures from HF's model:
  - every q, k, v, o and every expert's gate, up and down run through
    ``macro.linear`` under the configuration's per-tensor min/max
    activation quantizer; an expert's quantizer takes its range over the
    tokens routed to it (per-expert, per-tensor codes);
  - the router, the attention core (float32 scores and softmax), the
    norms and the tied head are digital;
  - the k weights are computed as a softmax over all E logits, its top k
    renormalised to sum to 1, which equals HF's softmax over the top k
    logits in exact arithmetic. In float32 the two orders part in the
    last bits, so about one bfloat16 weight in 10^5 rounds one step
    apart, and through 24 layers of per-tensor activation quantizers one
    such step in a prefill moved the served logits by up to 0.52 (an
    H100, seeds 3000000001 and 3000000003; the check's float8 control
    reads about 1): the reference takes the order in which the program
    computes them;
  - the top k break ties to the lower expert index (``torch.topk``
    promises no order among equal logits), and a token's weighted outputs
    are added in expert order, one rounding per add (HF's ``index_add``
    adds in launch order);
  - no attention dropout (serving).

It serves as ``qwen2.Qwen2.serve`` does: a prefill over the prompt batch,
then one step per token against its own K/V, teacher-forced. Arithmetic
and the control (``act_dtype=torch.float8_e4m3fn``) are ``qwen2``'s.

The tree of raw weights is the benchmark's (``adapters/granite_moe.py``):
{"embed": {"table": [V_pad, D]}, "final_norm": {"scale": [D]},
"layers": [{"norm1", "wq", "wk", "wv", "wo", "norm2", "router" [D, E],
"gate" [E, D, F], "up" [E, D, F], "down" [E, F, D]}, ...]}.
"""

from __future__ import annotations

import torch

from perfbench.reference import macro, qwen2

ATTENTION = ("wq", "wk", "wv", "wo")
EXPERTS = ("gate", "up", "down")


class GraniteMoe(qwen2.Qwen2):
    def __init__(self, weights: dict, cfg: dict, *,
                 act_dtype: torch.dtype | None = None):
        self.w, self.cfg = weights, cfg
        self.op = macro.OperatingPoint.from_json(cfg["cim"])
        self.dtype = getattr(torch, cfg["activation_dtype"])
        self.round_to = act_dtype  # None: the configuration's dtype
        self.plans = [
            {name: macro.plan(layer[name], self.op) for name in ATTENTION}
            | {name: [macro.plan(w, self.op) for w in layer[name]]
               for name in EXPERTS}
            for layer in weights["layers"]]
        self.d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.top_k = cfg["num_experts_per_tok"]
        self.r = cfg["residual_multiplier"]

    def _expert(self, x, i, e, name):
        return self._act(macro.linear(x, self.plans[i][name][e], self.op,
                                      symmetric=self.cfg["act_symmetric"],
                                      clip_pct=self.cfg["act_clip_pct"]))

    def _attention(self, q, k, v, q_pos, k_pos):
        """``qwen2``'s core with the scores scaled by the attention
        multiplier."""
        b, s = q.shape[:2]
        g = self.kv_heads
        qg = q.reshape(b, s, g, self.heads // g, self.hd).to(torch.float32)
        kf, vf = k.to(torch.float32), v.to(torch.float32)
        scores = (torch.einsum("bsgrh,btgh->bgrst", qg, kf)
                  * self.cfg["attention_multiplier"])
        mask = k_pos[None, :] <= q_pos[:, None]  # [S, T]
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrst,btgh->bsgrh", probs, vf)
        return self._act(out.reshape(b, s, self.heads * self.hd))

    def _moe(self, x, i):
        """The MoE layer on x [T, D]."""
        layer = self.w["layers"][i]
        logits = self._act(x @ layer["router"].to(self.dtype))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        chosen = top.indices[:, :self.top_k]
        p = top.values[:, :self.top_k]
        gates = self._act(p / torch.sum(p, dim=-1, keepdim=True))
        out = torch.zeros_like(x)
        for e in range(layer["router"].shape[1]):
            rows, slot = torch.nonzero(chosen == e, as_tuple=True)
            if not len(rows):
                continue
            xe = x[rows]
            g = self._expert(xe, i, e, "gate")
            u = self._expert(xe, i, e, "up")
            sig = self._act(torch.reciprocal(self._act(1 + self._act(
                torch.exp(self._act(-g))))))
            y = self._expert(self._act(self._act(g * sig) * u), i, e, "down")
            out[rows] = self._act(out[rows] + self._act(
                gates[rows, slot][:, None] * y))
        return out

    def _layer(self, x, i, positions, cache):
        layer = self.w["layers"][i]
        b, s, _ = x.shape
        h = self._norm(x, layer["norm1"])
        q = self._linear(h, layer, i, "wq").reshape(b, s, self.heads, self.hd)
        k = self._linear(h, layer, i, "wk").reshape(b, s, self.kv_heads,
                                                    self.hd)
        v = self._linear(h, layer, i, "wv").reshape(b, s, self.kv_heads,
                                                    self.hd)
        q, k = self._rope(q, positions), self._rope(k, positions)
        if cache[i] is not None:
            k = torch.cat([cache[i][0], k], dim=1)
            v = torch.cat([cache[i][1], v], dim=1)
        cache[i] = (k, v)
        k_pos = torch.arange(k.shape[1], device=x.device)
        a = self._linear(self._attention(q, k, v, positions, k_pos), layer, i,
                         "wo")
        x = self._act(x + self._act(a * self.r))
        h = self._norm(x, layer["norm2"])
        m = self._moe(h.reshape(b * s, self.d), i).reshape(b, s, self.d)
        return self._act(x + self._act(m * self.r))

    def _logits(self, x):
        return super()._logits(x) / self.cfg["logits_scaling"]

    def _embed(self, ids):
        table = self.w["embed"]["table"]
        return self._act(self._act(table[ids])
                         * self.cfg["embedding_multiplier"])

    @torch.no_grad()
    def serve(self, prompts: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Teacher-forced serving: prefill ``prompts`` [B, S], then a
        decode step for each of ``tokens`` [B, n] but the last; returns
        the logits [B, n, vocab] (float32) that chose each of the n."""
        b, s = prompts.shape
        cache = [None] * len(self.w["layers"])
        x = self._embed(prompts)
        pos = torch.arange(s, device=prompts.device)
        for i in range(len(cache)):
            x = self._layer(x, i, pos, cache)
        out = [self._logits(x).to(torch.float32)]
        for j in range(tokens.shape[1] - 1):
            x = self._embed(tokens[:, j:j + 1])
            pos = torch.tensor([s + j], device=prompts.device)
            for i in range(len(cache)):
                x = self._layer(x, i, pos, cache)
            out.append(self._logits(x).to(torch.float32))
        return torch.stack(out, dim=1)


def attention_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one layer's four attention projections."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]


def expert_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one expert's three projections."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [("gate", d, f), ("up", d, f), ("down", f, d)]


def pass_macs(cfg: dict, batch: int, start: int, length: int) -> int:
    """Multiply-accumulates a pass over positions start .. start +
    length - 1 of ``batch`` sequences needs: the attention projections,
    the router, each token's k experts (the routed work, not the E
    experts'), attention over the keys each query sees (causal), and the
    head at the last position only."""
    tokens = batch * length
    attn_proj = sum(k * n for _, k, n in attention_shapes(cfg))
    router = cfg["hidden_size"] * cfg["num_local_experts"]
    routed = cfg["num_experts_per_tok"] * sum(
        k * n for _, k, n in expert_shapes(cfg))
    keys = sum(start + j + 1 for j in range(length))  # per sequence
    q_dim = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = 2 * q_dim * keys * batch
    head = batch * cfg["hidden_size"] * cfg["vocab_size"]
    return (cfg["num_hidden_layers"]
            * (tokens * (attn_proj + router + routed) + attn) + head)
