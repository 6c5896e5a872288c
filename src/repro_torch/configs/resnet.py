"""The paper's ResNet configuration, its trained checkpoint and policy.

``RESNET_CFG`` is the network the JAX package trained and committed at
``results/resnet_baseline/step_00000400``: the ResNet-20 channel plan
(16/32/64) at 2 blocks per stage, 10 classes, trained in fp32 on
``SyntheticCIFAR(n_classes=10, seed=0, noise=2.2)``. ``cim_policy`` is
the paper operating-point policy the accuracy studies evaluate it under:
stem conv and fc layer digital, percentile-clipped (0.995) unsigned
activation ranges.
"""

from __future__ import annotations

import pathlib
from typing import Any

from repro_torch.checkpoint import store
from repro_torch.configs.base import CIMPolicy
from repro_torch.core.params import CIMConfig
from repro_torch.data.synthetic import SyntheticCIFAR
from repro_torch.models.resnet import ResNetConfig

N_CLASSES = 10
CHECKPOINT_DIR = (
    pathlib.Path(__file__).resolve().parents[3] / "results" / "resnet_baseline"
)

RESNET_CFG = ResNetConfig(
    n_classes=N_CLASSES,
    widths=(16, 32, 64),
    blocks_per_stage=2,
    cim=CIMPolicy(mode="fp", act_symmetric=True),
)


def dataset() -> SyntheticCIFAR:
    """The synthetic task the checkpoint was trained on."""
    return SyntheticCIFAR(n_classes=N_CLASSES, seed=0, noise=2.2)


def cim_policy(
    *, mode: str = "cim", rows: int = 16, cutoff: float = 0.5,
    adc_bits: int = 4, noisy: bool = False, vdd: float = 0.6,
    act_clip_pct: float = 0.995,
) -> CIMPolicy:
    """Paper operating-point policy: stem conv digital (first-layer
    exemption), fc digital, percentile-calibrated activation ranges."""
    return CIMPolicy(
        mode=mode,
        cim=CIMConfig(rows_active=rows, cutoff=cutoff, adc_bits=adc_bits,
                      noisy=noisy, vdd=vdd),
        act_symmetric=True,
        act_clip_pct=act_clip_pct,
        apply_to_logits=False,
        apply_to_stem=False,
    )


def load_baseline(
    directory: str | pathlib.Path = CHECKPOINT_DIR, *, device: Any = "cuda"
) -> tuple[dict, dict]:
    """(params, bn_state) of the committed checkpoint, as tensors."""
    tree = store.restore(directory, device=device)
    return tree["params"], tree["bn"]
