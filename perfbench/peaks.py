"""The card's published peaks and the lower bounds built on them.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the full 700 W
power limit: 1,979 TOP/s int8 (and fp8), 989 TFLOP/s bfloat16,
3.35 TB/s of HBM bandwidth. Every product the macro models is of integer
codes of at most 8 bits, so shares of the whole step and of the macro's
kernels are taken against the int8 rate.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def macro_bound_s(prod: dict, act_bits: int, weight_bits: int) -> float:
    """The least time one macro matmul [M, K] x [K, N] can take:
    max(2 M K N / int8 peak, bytes / HBM bandwidth), each byte counted
    once at the model's widths: the layer's input activations at
    ``act_bits`` (for a conv the feature map, ``in_elems``, not its
    im2col expansion), the weights at ``weight_bits``, the output at
    ``out_bytes`` per element."""
    m, k, n = prod["m"], prod["k"], prod["n"]
    ops = 2 * m * k * n
    nbytes = (prod["in_elems"] * act_bits / 8 + k * n * weight_bits / 8
              + m * n * prod["out_bytes"])
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
