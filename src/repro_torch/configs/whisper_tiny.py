"""whisper-tiny [audio]: enc-dec, 4L each, d=384 6H d_ff=1536
vocab=51865; the conv frontend is a stub (the caller passes precomputed
frame embeddings as ``encoder_frames``). [arXiv:2212.04356]

max_seq_len (32k) far exceeds Whisper's trained 448-token context, as in
the JAX package's config; long_500k is skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    mlp_act="gelu",
    learned_pos_emb=True,
    frontend="audio_frames",
    frontend_seq=1500,  # 30 s of log-mel frames after the conv stub
    microbatches=2,
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    name="whisper-tiny-smoke",
    n_layers=2,
    n_encoder_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    frontend_seq=16,
    max_seq_len=256,
    microbatches=1,
)
