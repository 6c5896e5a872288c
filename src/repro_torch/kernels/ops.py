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
activation codes are widened to int32 when they come narrower. ``bn``
pins the kernel's column tile (16, 32 or 64; None picks it by N).

``register_tuned_backend`` registers an engine backend that pins B1's
block through dispatch, the hook a deployment uses to fix the tiling
without forking the dispatch code (per-shape pins normally come from
``kernels.autotune``'s cache instead).
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
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """P-8T GPQ matmul via B1; drop-in for ``matmul.cim_matmul_int``."""
    return gpq_matmul(*_operands(x_codes, w_codes), cfg, bn=bn)


def adder_tree_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """Merged-transfer matmul via B2; drop-in for
    ``variants.adder_tree_matmul_int`` (noise off)."""
    return adder_tree_gpq_matmul(*_operands(x_codes, w_codes), cfg, bn=bn)


def cell_adc_matmul_kernel(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    bn: int | None = None,
) -> torch.Tensor:
    """Cell-embedded-ADC matmul via B3; bit-identical to the floor
    transfer noise-free, so a drop-in for ``matmul.cim_matmul_int`` at a
    cell-adc operating point."""
    return cell_adc_gpq_matmul(*_operands(x_codes, w_codes), cfg, bn=bn)


def register_tuned_backend(*, bn: int, name: str = "cuda-tuned") -> str:
    """Register an engine backend that runs B1 at column tile ``bn``.

    Returns the backend key; select it with ``CIMPolicy(backend=<key>,
    mode="cim-kernel", ...)``. The call goes through ``kernels.dispatch``
    (backend "cuda", block ``dispatch.cuda_block(rows_active, bn)``), so
    the resolution log sees it like any other kernel execution.
    """
    from repro_torch.core import engine  # engine reaches ops lazily
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cim_mac import check_bn

    if not check_bn(bn):
        raise ValueError("register_tuned_backend pins a column tile; got "
                         f"bn={bn!r}")

    def _int_fn(x_codes, plan, cfg, generator):
        return dispatch.dispatch(
            x_codes, plan.codes, cfg, backend="cuda", generator=generator,
            planes=plan.planes,
            block=dispatch.cuda_block(cfg.rows_active, bn),
        )

    engine.register_backend(name, engine.quantized_backend(_int_fn),
                            overwrite=True)
    return name
