"""Public wrappers around the hand-written kernels.

Model code reaches this module through ``kernels.dispatch`` (the
KernelKey table; the engine's ``cuda`` backend resolves its kernel
there). On a CUDA tensor each wrapper launches its kernel; on a CPU
tensor it runs the kernel's plain PyTorch version, which is how the CPU
tests hold the wrappers to the reference.

  cim_matmul_kernel         P-8T per-plane coarse-fine flash (GPQ, B1)
  adder_tree_matmul_kernel  merged single-ADC conversion (2212.04320, B2)
  cell_adc_matmul_kernel    in-array SAR per-row references (2307.05944, B3)

Each is noiseless by design (the production inference path) and takes
``w_codes`` as int8 signed codes or a plan's uint8 packed-plane bytes;
activation codes are widened to int32 when they come narrower.
"""

from __future__ import annotations

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec
from repro_torch.kernels.cim_mac import (
    adder_tree_gpq_matmul,
    cell_adc_gpq_matmul,
    gpq_matmul,
)


def _operands(x_codes: torch.Tensor, w_codes: torch.Tensor):
    if x_codes.dtype != torch.int32:
        x_codes = x_codes.to(torch.int32)
    return x_codes.contiguous(), w_codes.contiguous()


def cim_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
) -> torch.Tensor:
    """P-8T GPQ matmul via B1; drop-in for ``matmul.cim_matmul_int``."""
    return gpq_matmul(*_operands(x_codes, w_codes), cfg)


def adder_tree_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
) -> torch.Tensor:
    """Merged-transfer matmul via B2; drop-in for
    ``variants.adder_tree_matmul_int`` (noise off)."""
    return adder_tree_gpq_matmul(*_operands(x_codes, w_codes), cfg)


def cell_adc_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
) -> torch.Tensor:
    """Cell-embedded-ADC matmul via B3; bit-identical to the floor
    transfer noise-free, so a drop-in for ``matmul.cim_matmul_int`` at a
    cell-adc operating point."""
    return cell_adc_gpq_matmul(*_operands(x_codes, w_codes), cfg)
