"""The benchmark's input generators, made from ``--seed``.

Copies of the program's ``data/synthetic.py`` task generators (the
benchmark imports nothing of the program's data code): ``MarkovLM`` as
there, and ``SyntheticCIFAR``'s class prototypes as there, with the
labels and the noise drawn on the device in one call each so that a pool
of batches costs little set-up. Every seed gives every cell the same
sizes; only the values move.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from ``seed`` and a path of small ints."""
    ss = np.random.SeedSequence([seed & (2**63 - 1), seed >> 63, *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


class MarkovLM:
    """Order-2 Markov chain token stream with a fixed random kernel
    (``data/synthetic.py``'s, line for line)."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self._mix = rng.integers(1, 2**31 - 1, size=3)
        self.branching = branching

    def _succ(self, a, b, r):
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


def lm_prompts(vocab: int, batch: int, length: int, pool: int, seed: int,
               device) -> list[torch.Tensor]:
    """``pool`` distinct prompt batches [batch, length] (int64 ids)."""
    lm = MarkovLM(vocab, seed=sub_seed(seed, 1))
    return [torch.from_numpy(lm.sample(batch, length - 1,
                                       sub_seed(seed, 2, j))).long().to(device)
            for j in range(pool)]


def cifar_prototypes(n_classes: int, seed: int) -> np.ndarray:
    """[classes, 32, 32, 3] low-frequency class patterns
    (``SyntheticCIFAR.__init__``'s)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    protos = []
    for _ in range(n_classes):
        f = rng.uniform(1.0, 4.0, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
        amp = rng.uniform(0.5, 1.0, size=(3,))
        protos.append(np.stack(
            [amp[c] * np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy)
                             + ph[c, 0]) for c in range(3)], axis=-1))
    return np.stack(protos).astype(np.float32)


def cifar_pool(n_classes: int, batch: int, pool: int, noise: float,
               seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images [pool, batch, 32, 32, 3] float32, labels [pool, batch]):
    class prototypes plus Gaussian noise, as SyntheticCIFAR's held-out
    batches (no augmentation)."""
    protos = torch.from_numpy(cifar_prototypes(n_classes,
                                               sub_seed(seed, 3))).to(device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    labels = torch.randint(0, n_classes, (pool, batch), generator=gen,
                           device=device)
    noise_t = torch.randn((pool, batch) + tuple(protos.shape[1:]),
                          generator=gen, device=device)
    return protos[labels] + noise * noise_t, labels
