"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2; Mamba+attention 1:7 interleave, MoE on every
2nd layer. [arXiv:2403.19887; hf]

Pattern unit = 8 layers (1 attn + 7 mamba), MoE on odd layers within the
unit -> 72 = 9 scanned units. 16 experts x 3*8192*24576 over 36 MoE
layers reproduces the ~398B total / ~94B active split.
"""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    layer_pattern=("attn",) + ("mamba",) * 7,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24_576, every=2,
                  offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=1_048_576,
    microbatches=8,
    remat="layer",
    # 398B parameters: bfloat16 params, optimizer moments and gradient
    # accumulation (the JAX package's values).
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="jamba-1.5-large-smoke",
    n_layers=8,  # one full pattern unit
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=256, every=2, offset=1),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk_size=16),
    max_seq_len=256,
    microbatches=1,
    param_dtype="float32",
    opt_state_dtype="float32",
    grad_accum_dtype="float32",
)
