"""Data: deterministic synthetic tasks and the sharded prefetch loader."""

from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import MarkovLM, SyntheticCIFAR

__all__ = ["MarkovLM", "ShardedLoader", "SyntheticCIFAR"]
