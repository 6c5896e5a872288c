"""The paper's ResNet configuration, its trained checkpoint and policy.

``RESNET_CFG`` is the network the JAX package trained and committed at
``results/resnet_baseline/step_00000400``: the ResNet-20 channel plan
(16/32/64) at 2 blocks per stage, 10 classes, trained in fp32 on
``SyntheticCIFAR(n_classes=10, seed=0, noise=2.2)``. ``cim_policy`` is
the paper operating-point policy the accuracy studies evaluate it under:
stem conv and fc layer digital, percentile-clipped (0.995) unsigned
activation ranges. ``train_resnet_baseline`` trains that checkpoint again
(or loads it) as the JAX package's ``benchmarks/common.py`` does.
"""

from __future__ import annotations

import pathlib
from typing import Any

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import CIMPolicy
from repro_torch.core.params import CIMConfig
from repro_torch.data.synthetic import SyntheticCIFAR
from repro_torch.device import full_float32
from repro_torch.models import resnet
from repro_torch.models.resnet import ResNetConfig
from repro_torch.optim import adamw

N_CLASSES = 10
_ROOT = pathlib.Path(__file__).resolve().parents[3]
CHECKPOINT_DIR = _ROOT / "results" / "resnet_baseline"
# Where this package saves a baseline it trains (it never writes results/).
BUILD_DIR = _ROOT / "build" / "resnet_baseline"

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


def train_resnet_baseline(
    *, steps: int = 400, batch: int = 64, lr: float = 2e-3, seed: int = 0,
    cache: bool = True, device: Any = "cuda",
) -> tuple[dict, dict]:
    """Train (or load) the fp32 baseline the CIM studies evaluate:
    (params, bn_state) on ``device``.

    Under ``cache`` it loads the committed checkpoint (``CHECKPOINT_DIR``)
    when there is one, else one this function saved (``BUILD_DIR``), else
    trains and saves there at step ``steps`` in the JAX package's
    ``{"params", "bn"}`` layout. Training is ``benchmarks/common.py``'s:
    ``steps`` AdamW steps (warm-up 20, cosine, weight decay 1e-4) of
    ``resnet.loss_fn`` with batch statistics over ``dataset().batch(batch,
    step=s)``, in full float32 (TF32 off for the step, then restored).
    """
    if cache:
        for directory in (CHECKPOINT_DIR, BUILD_DIR):
            if store.latest_step(directory) is not None:
                return load_baseline(directory, device=device)
    params, bn = resnet.init(seed, RESNET_CFG, device=device)
    opt_cfg = adamw.OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps,
                                    weight_decay=1e-4, schedule="cosine")
    opt = adamw.init_state(params)
    ds = dataset()
    with full_float32():
        for s in range(steps):
            b = ds.batch(batch, step=s)
            data = {"image": torch.from_numpy(b["image"]).to(device),
                    "label": torch.from_numpy(b["label"]).to(device)}
            p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, (bn, _) = resnet.loss_fn(p, bn, data, RESNET_CFG,
                                           train=True)
            grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(p)))
            params, opt, _ = adamw.apply_updates(
                params, adamw.tree_map(lambda _: next(grads), params), opt,
                opt_cfg)
    if cache:
        store.save({"params": params, "bn": bn}, BUILD_DIR, steps)
    return params, bn
