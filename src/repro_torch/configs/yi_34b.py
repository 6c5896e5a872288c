"""yi-34b [dense]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA. [arXiv:2403.04652; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    max_seq_len=32_768,
    microbatches=8,
)

SMOKE = CONFIG.replace(
    name="yi-34b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    max_seq_len=256,
    microbatches=1,
)
