"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-27b-pt; unverified]

62 = 10 units of (5 local + 1 global) + 2 local tail layers -- the tail
runs unrolled after the stacked units (models.transformer._unit_split).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    window_size=1024,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    microbatches=8,
)

SMOKE = CONFIG.replace(
    name="gemma3-27b-smoke",
    n_layers=8,  # 1 unit + 2 tail
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    window_size=32,
    max_seq_len=256,
    microbatches=1,
)
