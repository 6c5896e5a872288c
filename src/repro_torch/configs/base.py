"""Execution-policy and model configuration records, and the arch registry.

``CIMPolicy`` says where and how the paper's macro executes a model's
weight matmuls: the execution mode, the macro operating point and the
per-call knobs. ``ModelConfig`` describes one LM architecture; each
ported architecture is a module ``repro_torch/configs/<id>.py`` with a
``CONFIG`` (the published widths and depth) and a ``SMOKE`` (a narrow
same-family configuration for CPU tests). ``get_config`` maps ``--arch``
ids to those modules; the field values equal the JAX package's, whose
record lacks Granite's four multipliers (neutral in every module here).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Literal

from repro_torch.core.params import CIMConfig

LayerKind = Literal["attn", "attn_local", "mamba", "rwkv"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    n_shared: int = 0  # shared (always-on) experts
    d_shared: int = 0  # hidden size of the fused shared expert (0 = none)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    every: int = 1  # MoE MLP on layers where layer_idx % every == offset
    offset: int = 0
    dispatch: str = "grouped"  # 'grouped' | 'ragged'
    group_size: int = 4096  # tokens per routing group ('grouped')


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default: ceil(d_model / 16)
    scan_impl: Literal["sequential", "chunked"] = "chunked"
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64  # low-rank dim of the data-dependent decay
    mix_lora: int = 32  # low-rank dim of the ddlerp token-shift


@dataclasses.dataclass(frozen=True)
class CIMPolicy:
    """Where/how the paper's macro executes a model's weight matmuls.

    Consumed by the plan/execute engine (core.engine),
    models/common.linear_apply and models/resnet. Frozen and hashable.
    """

    mode: str = "fp"  # 'fp' | 'cim-exact' | 'cim' | 'cim-kernel'
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    # Execution backend key in core.engine's registry; '' derives the
    # backend from `mode` (the mode strings are registered aliases).
    backend: str = ""
    # Straight-through gradients through the macro forward (QAT); read by
    # engine.matmul.
    ste: bool = True
    # Which matmul families run through the macro.
    apply_to_attn_proj: bool = True
    apply_to_mlp: bool = True
    apply_to_experts: bool = True
    apply_to_logits: bool = False  # vocab matmul usually stays digital
    act_symmetric: bool = False  # True for post-ReLU (the paper's CNNs)
    # Percentile-clipped activation calibration (1.0 = plain min/max).
    act_clip_pct: float = 1.0
    # First (stem) conv sees raw signed inputs; production CIM CNNs keep
    # it digital (standard first/last-layer exemption).
    apply_to_stem: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu (plain up/down)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Granite's scalars on the decoder's residual and attention paths,
    # each applied only where it is not neutral (the encoder of an
    # encoder-decoder takes none): x = embed(ids) * embedding_multiplier;
    # scores = q.k * attention_multiplier (0: head_dim ** -0.5);
    # x = x + branch * residual_multiplier; logits = head(x) /
    # logits_scaling. The JAX package has none of them.
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # Layer pattern, cycled across the stack: gemma3 = 5 local + 1
    # global, jamba = 1 attn + 7 mamba, rwkv = all 'rwkv', dense = all
    # 'attn'.
    layer_pattern: tuple[LayerKind, ...] = ("attn",)
    window_size: int = 0  # for 'attn_local'
    max_seq_len: int = 131_072
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    # encoder-decoder (whisper): encoder reuses the same dims.
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality frontend stub: model consumes precomputed embeddings.
    frontend: str = ""  # '' | 'audio_frames' | 'vision_patches'
    frontend_seq: int = 0  # stub frontend sequence length
    learned_pos_emb: bool = False  # whisper-style absolute positions
    cim: CIMPolicy = dataclasses.field(default_factory=CIMPolicy)
    # dtypes
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # KV-cache storage dtype (float8_e4m3fn halves the cache traffic).
    kv_cache_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    # distribution and training knobs; remat is read by
    # transformer.forward_train (any value but 'none' recomputes each layer).
    remat: str = "full"  # 'none' | 'dots' | 'full'
    scan_layers: bool = True  # stack identical units under params["units"]
    microbatches: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # Embedding tables and lm_head are padded to a multiple of this; pad
    # columns are masked to -1e30 in the logits, so argmax and softmax
    # mass are unchanged.
    vocab_pad_to: int = 256

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        """The factor on the attention scores."""
        return self.attention_multiplier or self.head_dim ** -0.5

    def layer_kind(self, i: int) -> LayerKind:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_uses_moe(self, i: int) -> bool:
        return self.moe is not None and i % self.moe.every == self.moe.offset

    @property
    def pattern_len(self) -> int:
        """Length of the repeating layer unit (the stacked unit)."""
        if self.moe is None:
            return len(self.layer_pattern)
        return math.lcm(len(self.layer_pattern), self.moe.every)

    def param_count(self) -> int:
        """Analytical parameter count (embeddings included once)."""
        d = self.d_model
        total = self.vocab_size * d  # embedding
        total += d  # final norm
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "attn_local"):
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            elif kind == "mamba":
                mc = self.mamba
                d_in = mc.expand * d
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_in  # in_proj
                total += d_in * mc.d_conv  # conv
                total += d_in * (dt_rank + 2 * mc.d_state)  # x_proj
                total += dt_rank * d_in + d_in  # dt_proj
                total += d_in * mc.d_state + d_in  # A, D
                total += d_in * d  # out_proj
            elif kind == "rwkv":
                rc = self.rwkv
                total += 5 * d * d  # r, k, v, g, o
                total += 2 * (d * rc.decay_lora + rc.decay_lora * d)
                total += 5 * (d * rc.mix_lora + rc.mix_lora * d)
            if self.layer_uses_moe(i):
                mo = self.moe
                total += d * mo.n_experts  # router
                total += mo.n_experts * 3 * d * mo.d_expert
                if mo.d_shared:
                    total += 3 * d * mo.d_shared
            elif self.mlp_act == "silu":
                total += 3 * d * self.d_ff
            else:
                total += 2 * d * self.d_ff
            total += 2 * d  # norms
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            enc = self.n_encoder_layers * (
                4 * d * d
                + (2 if self.mlp_act == "gelu" else 3) * d * self.d_ff
                + 2 * d
            )
            xattn = self.n_layers * (4 * d * d + d)
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.layer_uses_moe(i)
        )
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_expert
        return self.param_count() - n_moe_layers * inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned LM shape set (identical across the 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "qwen1_5_4b",
    "qwen2_0_5b",
    "yi_34b",
    "gemma3_27b",
    "whisper_tiny",
    "jamba_1_5_large",
    "internvl2_2b",
    "qwen2_moe_a2_7b",
    "granite_moe_1b",
    "rwkv6_1_6b",
)

# Archs whose attention is fully quadratic -> long_500k is skipped.
FULL_ATTENTION_ARCHS = frozenset(
    {
        "qwen1_5_4b",
        "qwen2_0_5b",
        "yi_34b",
        "whisper_tiny",
        "internvl2_2b",
        "qwen2_moe_a2_7b",
        "granite_moe_1b",
    }
)


def shape_cells(arch_id: str) -> list[str]:
    """The assigned shape cells for one arch, with documented skips."""
    cells = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    if arch_id in FULL_ATTENTION_ARCHS:
        cells.remove("long_500k")
    return cells


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    """CONFIG (or SMOKE) of one arch, or of the paper's ResNet-20
    ("resnet20_cifar", a ``models.resnet.ResNetConfig``)."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS and arch_id != "resnet20_cifar":
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE if smoke else mod.CONFIG
