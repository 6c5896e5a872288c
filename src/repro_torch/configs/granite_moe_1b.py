"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) d_ff=512
(expert) vocab=49155; 32 experts top-8, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The record mirrors the JAX package's, which has no place for Granite's
four multipliers (embedding 12, attention 1/64, residual 0.22, logits
1/6): CONFIG and SMOKE leave them neutral, and the parity tests hold them
to the JAX package. The published model is the benchmark's
``perfbench/configs/granite-moe-1b.json``, which its adapter turns into a
``ModelConfig`` with the multipliers and dispatch='ragged' (each expert
through the macro on its own tokens only)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    tie_embeddings=True,
    microbatches=2,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    max_seq_len=4096,
)

SMOKE = CONFIG.replace(
    name="granite-moe-1b-a400m-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=4, d_expert=64),
    max_seq_len=256,
    microbatches=1,
)
