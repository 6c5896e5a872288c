"""rwkv6-1.6b "Finch" [ssm]: 24L d=2048 (attention-free) d_ff=7168
vocab=65536; data-dependent decay, head_size 64. [arXiv:2404.05892;
unverified]"""

from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    layer_pattern=("rwkv",),
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    max_seq_len=1_048_576,
    microbatches=4,
)

SMOKE = CONFIG.replace(
    name="rwkv6-1.6b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    rwkv=RWKVConfig(head_size=32, decay_lora=16, mix_lora=8),
    max_seq_len=256,
    microbatches=1,
)
