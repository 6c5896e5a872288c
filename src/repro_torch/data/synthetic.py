"""Deterministic synthetic CIFAR-shaped dataset (numpy only).

No datasets ship offline, so the ResNet is trained and evaluated on
class-conditional frequency/phase patterns plus Gaussian noise at
32x32x3: learnable, and quantization-sensitive enough to expose ADC
clipping. Same seeds give the same images as the JAX package's
``repro.data.synthetic.SyntheticCIFAR``.
"""

from __future__ import annotations

import numpy as np


class SyntheticCIFAR:
    """Class-conditional 32x32x3 pattern images, CIFAR-shaped (NHWC)."""

    def __init__(self, n_classes: int = 10, seed: int = 0,
                 noise: float = 0.35):
        rng = np.random.default_rng(seed)
        self.n_classes = n_classes
        self.noise = noise
        # Per-class basis: random low-frequency pattern per channel.
        yy, xx = np.mgrid[0:32, 0:32] / 32.0
        protos = []
        for _ in range(n_classes):
            f = rng.uniform(1.0, 4.0, size=(3, 2))
            ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
            amp = rng.uniform(0.5, 1.0, size=(3,))
            img = np.stack(
                [
                    amp[c]
                    * np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy)
                             + ph[c, 0])
                    for c in range(3)
                ],
                axis=-1,
            )
            protos.append(img)
        self.protos = np.stack(protos).astype(np.float32)  # [C, 32, 32, 3]

    def batch(self, batch: int, step: int, *, train: bool = True,
              shard: int = 0, n_shards: int = 1) -> dict:
        base = 0 if train else 1_000_000
        seed = base + step * n_shards + shard
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, self.n_classes, size=batch)
        imgs = self.protos[labels]
        imgs = imgs + self.noise * rng.standard_normal(imgs.shape).astype(
            np.float32
        )
        if train:
            # light augmentation: random shift
            sh = rng.integers(-2, 3, size=(batch, 2))
            imgs = np.stack(
                [np.roll(im, tuple(s), axis=(0, 1))
                 for im, s in zip(imgs, sh, strict=True)]
            )
        return {"image": imgs.astype(np.float32),
                "label": labels.astype(np.int32)}
