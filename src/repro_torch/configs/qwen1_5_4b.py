"""qwen1.5-4b [dense]: 40L d=2560 20H (kv=20, i.e. MHA) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-4B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=5_000_000.0,
    max_seq_len=32_768,
    microbatches=4,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-4b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    max_seq_len=256,
    microbatches=1,
)
