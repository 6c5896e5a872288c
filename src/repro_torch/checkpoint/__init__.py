"""Checkpoint substrate: the msgpack + zlib tensor store, async saves."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
