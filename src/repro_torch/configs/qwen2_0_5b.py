"""qwen2-0.5b [dense]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    name="qwen2-0.5b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    max_seq_len=256,
)
