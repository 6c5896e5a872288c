"""Carry weights across from the JAX package's trees to the port's tensors.

The JAX package's parameter and BatchNorm-state trees are nested dicts
of arrays (as its ``checkpoint.store.restore`` or ``models.resnet.init``
give them). ``to_torch`` turns such a tree, with numpy (or any
array-protocol) leaves, into the same nesting of tensors on a device:
same names, same layouts (HWIO filters, [K, N] matrices), same dtypes.
The checkpoint reader and the parity tests both go through it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """Nested dict of arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device=device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    arr = np.array(tree, copy=True)  # writable, owned: from_numpy shares it
    return torch.from_numpy(arr).to(device)
