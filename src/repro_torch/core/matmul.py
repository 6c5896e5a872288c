"""The integer macro matmuls: the GPQ scan twin and the exact product.

Semantics per output element, with K tiled into groups of
``rows_active`` rows (one ABL accumulation each):

    y[m, n] = sum_g sum_b sign_b * 2**b * step * ADC(
                  sum_{k in g} x[m, k] * bit_b(w[k, n]))

``cim_matmul_int`` is the plain twin of the reference's ``lax.scan``
transfer: a Python loop over the G groups, with peak memory one
[M, B*N] group tile. It runs on any device and is the behavioral
backend's default outside the hand kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import quant
from repro_torch.core.params import CIMConfig


def _pad_k_to_groups(k: int, rows: int) -> int:
    return (k + rows - 1) // rows * rows


def cim_matmul_int(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig,
    *,
    generator: torch.Generator | None = None,
    planes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped-partial-sum quantized (GPQ) matmul in integer units.

    Args:
      x_codes: [M, K] unsigned activation codes in [0, 2^act_bits).
      w_codes: [K, N] signed weight codes (weight_bits wide).
      cfg: macro operating point (rows_active = group size).
      generator: hardware-noise source when ``cfg.noisy``: one draw of
        [M, B, N] per group, in group order, from this one generator
        (the reference folds one key in per group instead).
      planes: optional plan planes in the grouped layout of
        ``engine.plan_weights`` (zero-padded along K): unpacked
        [G, weight_bits, rows_active, N] 0/1 planes, or bit-packed
        [G, rows_active, N] uint8 with 8 planes per byte.

    Returns [M, N] float32: the sum over groups and bit planes of the
    dequantized ADC codes with shift-add weighting.
    """
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k != k2:
        raise ValueError(f"K mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    rows = cfg.rows_active
    b = cfg.weight_bits
    k_pad = _pad_k_to_groups(k, rows)
    g = k_pad // rows
    dev = x_codes.device

    # Group pMACs are integers <= rows * act_max, exact in f32 whatever
    # the matmul precision: the contraction runs in f32 on any device.
    x_p = torch.nn.functional.pad(x_codes.to(torch.float32), (0, k_pad - k))
    x_g = x_p.reshape(m, g, rows).transpose(0, 1)  # [G, M, rows]
    signs = quant.plane_signs(b, dev).to(torch.float32)  # [B]

    if planes is None:
        w_p = torch.nn.functional.pad(w_codes.to(torch.int32),
                                      (0, 0, 0, k_pad - k))
        w_g = w_p.reshape(g, rows, n)

        def group_planes(gi):
            return quant.bitslice_weights(w_g[gi], b)  # [B, rows, N]
    elif planes.ndim == 3:
        if tuple(planes.shape) != (g, rows, n):
            raise ValueError(f"packed planes {tuple(planes.shape)} != "
                             f"{(g, rows, n)}")

        def group_planes(gi):
            return quant.bitslice_weights(planes[gi], b)
    else:
        if tuple(planes.shape) != (g, b, rows, n):
            raise ValueError(f"planes {tuple(planes.shape)} != "
                             f"{(g, b, rows, n)}")

        def group_planes(gi):
            return planes[gi]

    acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for gi in range(g):
        pg = group_planes(gi)  # [B, rows, N]
        flat = pg.to(torch.float32).permute(1, 0, 2).reshape(rows, b * n)
        pmac = (x_g[gi] @ flat).reshape(m, b, n)
        code = adc_lib.adc_transfer_int(pmac, cfg, generator=generator)
        pmac_hat = adc_lib.adc_dequant(code, cfg)  # [M, B, N]
        acc = acc + (pmac_hat * signs[:, None]).sum(dim=1)
    return acc


def cim_matmul_exact_int(
    x_codes: torch.Tensor, w_codes: torch.Tensor
) -> torch.Tensor:
    """Integer-exact path (the macro without ADC effects): x @ w as f32.

    The product is formed in float64, where every integer sum of these
    codes is exact, and then rounded once to float32 — what the
    reference's int32 dot followed by a cast gives. A float32 product is
    not integer-exact at deep K.
    """
    return (x_codes.to(torch.float64) @ w_codes.to(torch.float64)).to(
        torch.float32
    )
