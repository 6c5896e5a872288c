"""Public wrappers around the hand-written kernels.

Model code reaches this module through ``kernels.dispatch`` (the
KernelKey table; the engine's ``cuda`` backend resolves its kernel
there). On a CUDA tensor each wrapper launches its kernel; on a CPU
tensor it runs the kernel's plain PyTorch version, which is how the CPU
tests hold the wrappers to the reference.

  cim_matmul_kernel   P-8T per-plane coarse-fine flash (GPQ)

The adder-tree and cell-ADC variant kernels come with slice 2 of
ROADMAP.md.
"""

from __future__ import annotations

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec
from repro_torch.kernels.cim_mac import gpq_matmul


def cim_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
) -> torch.Tensor:
    """GPQ matmul via the hand-written kernel; drop-in for cim_matmul_int.

    Noiseless by design (the production inference path). ``w_codes`` is
    int8 signed codes or a plan's uint8 packed-plane bytes; activation
    codes are widened to int32 when they come narrower.
    """
    if x_codes.dtype != torch.int32:
        x_codes = x_codes.to(torch.int32)
    return gpq_matmul(x_codes.contiguous(), w_codes.contiguous(), cfg)
