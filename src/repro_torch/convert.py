"""Carry weights across from the JAX package's trees to the port's tensors.

The JAX package's parameter, BatchNorm-state, plan and cache trees are
nested dicts of arrays, of its ``PlannedWeights`` dataclass and of its
``KVCache``, ``MambaCache`` and ``RWKVCache`` named tuples (as its
``checkpoint.store.restore``, ``models.transformer.init``,
``core.engine.plan_params`` or ``models.transformer.init_caches`` give
them). ``to_torch`` turns such a
tree, with numpy (or any array-protocol) leaves, into the same nesting
on a device: same names, same layouts (HWIO filters, [K, N] matrices,
stacked [U, ...] units), same dtypes (bfloat16 and float8_e4m3fn too),
with the port's ``PlannedWeights`` and caches in place of the JAX
package's. The parity tests go through it; the checkpoint store shares
its integer views of bfloat16 and float8_e4m3fn (``VIEW_DTYPES``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# numpy extension dtypes (ml_dtypes, as JAX arrays convert to, and the
# checkpoint store's dtype names) that torch.from_numpy refuses: carried
# across bit for bit through an integer view of the same width.
VIEW_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _tensor(leaf: Any, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.array(leaf, copy=True)  # writable, owned: from_numpy shares it
    if arr.dtype.name in VIEW_DTYPES:
        as_int, dtype = VIEW_DTYPES[arr.dtype.name]
        return torch.from_numpy(arr.view(as_int)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def to_torch(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """Nested dict / plan / cache (KV, mamba or rwkv) of arrays -> the
    same nesting of tensors."""
    from repro_torch.core.engine import PlannedWeights
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba import MambaCache
    from repro_torch.models.rwkv import RWKVCache

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and hasattr(tree, "codes"):
        fields = {f.name: getattr(tree, f.name)
                  for f in dataclasses.fields(PlannedWeights)}
        return PlannedWeights(**{
            k: v if k == "weight_bits" else to_torch(v, device=device)
            for k, v in fields.items()})
    caches = {c._fields: c for c in (KVCache, MambaCache, RWKVCache)}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) in caches:
        return caches[tree._fields](*(to_torch(c, device=device)
                                      for c in tree))
    return _tensor(tree, device)
