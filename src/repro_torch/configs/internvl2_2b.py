"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553;
the InternViT frontend is a stub (the caller passes precomputed patch
embeddings as ``frontend_embeds``, prepended to the text tokens).
[arXiv:2404.16821; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    frontend="vision_patches",
    frontend_seq=256,  # ViT patch tokens per image after pixel-shuffle
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    microbatches=2,
)

SMOKE = CONFIG.replace(
    name="internvl2-2b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend_seq=8,
    max_seq_len=256,
    microbatches=1,
)
