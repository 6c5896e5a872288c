"""Deterministic synthetic datasets (numpy only).

No datasets ship offline, so the models are driven by structured
synthetic tasks. Same seeds give the same data as the JAX package's
``repro.data.synthetic``.

LM stream  : order-2 Markov chain over the vocab; a model must learn
             its transition structure.
CIFAR-like : class-conditional frequency/phase patterns plus Gaussian
             noise at 32x32x3: learnable, and quantization-sensitive
             enough to expose ADC clipping.
"""

from __future__ import annotations

import numpy as np


class MarkovLM:
    """Order-2 Markov chain token stream with a fixed random kernel."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # Sparse transition table: each (a, b) context allows `branching`
        # successors, hashed from the context (O(1) memory in vocab).
        self._mix = rng.integers(1, 2**31 - 1, size=3)
        self.branching = branching

    def _succ(self, a: np.ndarray, b: np.ndarray, r: np.ndarray
              ) -> np.ndarray:
        m0, m1, m2 = self._mix
        h = (a * m0 + b * m1 + r * m2) % (2**31 - 1)
        return (h % self.vocab).astype(np.int32)

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        """[batch, seq_len + 1] int32 tokens."""
        rng = np.random.default_rng(seed)
        toks = np.zeros((batch, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        toks[:, 1] = rng.integers(0, self.vocab, size=batch)
        branch = rng.integers(0, self.branching, size=(batch, seq_len + 1))
        for t in range(2, seq_len + 1):
            toks[:, t] = self._succ(toks[:, t - 2], toks[:, t - 1],
                                    branch[:, t])
        return toks

    def batch(self, batch: int, seq_len: int, step: int,
              *, shard: int = 0, n_shards: int = 1) -> dict:
        """Host-sharded batch: shard i of n gets a disjoint seed lane."""
        seed = step * n_shards + shard
        toks = self.sample(batch, seq_len, seed)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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
