"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (GQA kv=16) d_ff=1408(expert)
vocab=151936; 60 routed experts top-4 + shared expert (4-expert-
equivalent, 5632 wide, sigmoid-gated). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,  # dense fallback width (unused: MoE on every layer)
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632),
    max_seq_len=32_768,
    microbatches=4,
)

SMOKE = CONFIG.replace(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=4, d_expert=64, n_shared=4,
                  d_shared=256),
    max_seq_len=256,
    microbatches=1,
)
