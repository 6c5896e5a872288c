"""Kernels: the GPQ matmuls of the three macro variants on Hopper.

cim_mac.py  : the wrappers of the hand-written CUDA kernels (B1
              gpq_matmul, B2 adder_tree_gpq_matmul, B3
              cell_adc_gpq_matmul; sources in ``csrc/``, built by
              ``build`` at the first launch on a CUDA tensor, never at
              import) and their plain PyTorch versions.
ops.py      : the per-variant entry points over them.
ref.py      : the vectorized and spread-slot formulations, dispatch's
              "ref" and "slots" backends.
dispatch.py : the KernelKey(variant, backend, shape_cell, dtype) table
              every macro matmul routes through.
autotune.py : per-(arch, variant, shape-cell) sweeps and the tuning
              cache dispatch consults.
"""

from repro_torch.kernels.cim_mac import (
    adder_tree_gpq_matmul,
    cell_adc_gpq_matmul,
    gpq_matmul,
)
from repro_torch.kernels.dispatch import KernelKey, register_kernel
from repro_torch.kernels.ops import (
    adder_tree_matmul_kernel,
    cell_adc_matmul_kernel,
    cim_matmul_kernel,
)
from repro_torch.kernels.ref import adder_tree_matmul_ref, cim_matmul_ref

__all__ = [
    "KernelKey",
    "adder_tree_gpq_matmul",
    "adder_tree_matmul_kernel",
    "adder_tree_matmul_ref",
    "cell_adc_gpq_matmul",
    "cell_adc_matmul_kernel",
    "cim_matmul_kernel",
    "cim_matmul_ref",
    "gpq_matmul",
    "register_kernel",
]
