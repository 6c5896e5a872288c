"""Model zoo: the config-driven LM stack and the paper's ResNet.

transformer.py is the entry point of every LM arch (dense GQA,
local/global, MoE, Mamba hybrid, RWKV-6, encoder-decoder, VLM
frontend); resnet.py is the paper's CIFAR network of Table I.
"""

from repro_torch.models import (
    attention,
    common,
    mamba,
    moe,
    resnet,
    rwkv,
    transformer,
)

__all__ = [
    "attention",
    "common",
    "mamba",
    "moe",
    "resnet",
    "rwkv",
    "transformer",
]
