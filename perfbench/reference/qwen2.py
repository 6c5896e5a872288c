"""Qwen2 (arXiv:2407.10671) in plain PyTorch, every projection through
the reference macro: the benchmark's yardstick for the LM cells.

A pre-norm decoder: RMSNorm, grouped-query attention with RoPE on q and
k and biases on the q, k and v projections, a residual add, RMSNorm,
SwiGLU (down(silu(gate x) * up x)), a residual add; a final RMSNorm and
the head tied to the embedding table (digital). Every q, k, v, o, gate,
up and down projection runs through ``macro.linear`` under the
configuration's asymmetric per-tensor min/max activation quantizer.

It serves as the engine does: a prefill over the prompt batch [B, S]
(causal attention; every projection quantizes its whole [B * S, K]
input at once), then one step per token for the batch [B] against its
own K/V, which it keeps in the activation dtype. The quantizer's range
is per call, so a prefill and a decode step are not one full forward.

Arithmetic follows the configuration: activations, norms' outputs, the
residual stream and the K/V in ``activation_dtype`` (bfloat16), the
norms' statistics, RoPE and the attention scores in float32,
``silu(x) = x * (1 / (1 + exp(-x)))`` rounded after each op.
``act_dtype=torch.float8_e4m3fn`` is the control of the benchmark's
check: every tensor the model would hold in bfloat16 is rounded through
float8 e4m3 at that point (computation stays in bfloat16).

The tree of raw weights is the benchmark's (``adapters/lm.py``):
{"embed": {"table": [V_pad, D]}, "final_norm": {"scale": [D]},
"layers": [{"norm1", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "norm2",
"gate", "up", "down"}, ...]} with [K, N] weights.
"""

from __future__ import annotations

import torch

from perfbench.reference import macro

PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


class Qwen2:
    def __init__(self, weights: dict, cfg: dict, *,
                 act_dtype: torch.dtype | None = None):
        self.w, self.cfg = weights, cfg
        self.op = macro.OperatingPoint.from_json(cfg["cim"])
        self.dtype = getattr(torch, cfg["activation_dtype"])
        self.round_to = act_dtype  # None: the configuration's dtype
        self.plans = [{name: macro.plan(layer[name], self.op)
                       for name in PROJECTIONS} for layer in weights["layers"]]
        self.d = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        """x held in the activation dtype (through float8 for the
        control)."""
        x = x.to(self.dtype)
        if self.round_to is not None:
            x = x.to(self.round_to).to(self.dtype)
        return x

    def _linear(self, x, layer, i, name):
        y = macro.linear(x, self.plans[i][name], self.op,
                         symmetric=self.cfg["act_symmetric"],
                         clip_pct=self.cfg["act_clip_pct"])
        y = self._act(y)
        bias = "b" + name[1:] if name in ("wq", "wk", "wv") else None
        if bias is not None and bias in layer:
            y = self._act(y + layer[bias].to(self.dtype))
        return y

    def _norm(self, x, scale):
        x32 = x.to(torch.float32)
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.cfg["rms_norm_eps"])
        return self._act(y * scale.to(torch.float32))

    def _rope(self, x, positions):
        """x [B, S, H, hd], positions [S] -> rotated, in x's dtype."""
        hd = x.shape[-1]
        ar = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
        freqs = 1.0 / (self.cfg["rope_theta"] ** (ar / hd))
        ang = positions.to(torch.float32)[:, None] * freqs  # [S, hd/2]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return self._act(out)

    def _attention(self, q, k, v, q_pos, k_pos):
        """q [B, S, H, hd], k/v [B, T, KVH, hd]; query at q_pos attends
        keys at k_pos <= q_pos. Scores and softmax in float32."""
        b, s = q.shape[:2]
        g = self.kv_heads
        qg = q.reshape(b, s, g, self.heads // g, self.hd).to(torch.float32)
        kf, vf = k.to(torch.float32), v.to(torch.float32)
        scores = torch.einsum("bsgrh,btgh->bgrst", qg, kf) * self.hd ** -0.5
        mask = k_pos[None, :] <= q_pos[:, None]  # [S, T]
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrst,btgh->bsgrh", probs, vf)
        return self._act(out.reshape(b, s, self.heads * self.hd))

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
        x = self._act(x + a)
        h = self._norm(x, layer["norm2"])
        g = self._linear(h, layer, i, "gate")
        u = self._linear(h, layer, i, "up")
        sig = self._act(torch.reciprocal(self._act(1 + self._act(
            torch.exp(self._act(-g))))))
        m = self._linear(self._act(self._act(g * sig) * u), layer, i, "down")
        return self._act(x + m)

    def _logits(self, x):
        """Last position's logits [B, vocab] over the real vocabulary."""
        h = self._norm(x[:, -1], self.w["final_norm"])
        table = self.w["embed"]["table"].to(self.dtype)
        logits = h @ table.T
        return logits[:, :self.cfg["vocab_size"]]

    @torch.no_grad()
    def serve(self, prompts: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Teacher-forced serving: prefill ``prompts`` [B, S], then a
        decode step for each of ``tokens`` [B, n] but the last; returns
        the logits [B, n, vocab] (float32) that chose each of the n."""
        b, s = prompts.shape
        cache = [None] * len(self.w["layers"])
        x = self._act(self.w["embed"]["table"][prompts])
        pos = torch.arange(s, device=prompts.device)
        for i in range(len(cache)):
            x = self._layer(x, i, pos, cache)
        out = [self._logits(x).to(torch.float32)]
        for j in range(tokens.shape[1] - 1):
            x = self._act(self.w["embed"]["table"][tokens[:, j:j + 1]])
            pos = torch.tensor([s + j], device=prompts.device)
            for i in range(len(cache)):
                x = self._layer(x, i, pos, cache)
            out.append(self._logits(x).to(torch.float32))
        return torch.stack(out, dim=1)


def projection_shapes(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one layer's seven macro projections."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    ff = cfg["intermediate_size"]
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("gate", d, ff), ("up", d, ff), ("down", ff, d)]


def pass_macs(cfg: dict, batch: int, start: int, length: int) -> int:
    """Multiply-accumulates a pass over positions start .. start +
    length - 1 of ``batch`` sequences needs: every projection, attention
    over the keys each query sees (causal), and the head at the last
    position only (the position whose logits are used)."""
    tokens = batch * length
    proj = sum(k * n for _, k, n in projection_shapes(cfg))
    keys = sum(start + j + 1 for j in range(length))  # per sequence
    q_dim = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = 2 * q_dim * keys * batch
    head = batch * cfg["hidden_size"] * cfg["vocab_size"]
    return cfg["num_hidden_layers"] * (tokens * proj + attn) + head
