"""Vectorized statements of the GPQ matmul (the "ref" and "slots" backends).

Independent of the group loops of core/matmul.py and core/variants.py
on purpose: this is the "textbook" statement of the macro semantics,

  pmac[m, g, b, n] = sum_{k in group g} x[m, k] * bit_b(w[k, n])
  code             = clip(floor(pmac / step), 0, 2**adc_bits - 1)
  y[m, n]          = sum_{g, b} sign_b * step * code

and of the adder-tree's merged single-ADC transfer (one conversion of
``merged = sum_b sign_b 2^b pmac_b`` per group and output), both
noiseless by definition. The spread-slot form packs ``per_slot`` bit
planes per f32 at an exact-integer stride, so one batched contraction
yields every plane pMAC and the epilogue recovers them by
floor/multiply field extraction. Plain PyTorch ops; the reference has
no TPU kernel for these.
"""

from __future__ import annotations

from typing import Iterator

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.quant import (
    bitslice_weights,
    plane_signs,
    slot_spec,
    true_divide,
)
from repro_torch.core.variants import merged_quant


def _grouped_operands(x_codes, w_codes, cfg, planes):
    """Normalize (w_codes | plan planes) -> xg [M,G,rows], wp [B,G,rows,N]."""
    m, k = x_codes.shape
    rows = cfg.rows_active
    b = cfg.weight_bits
    k_pad = -(-k // rows) * rows
    g = k_pad // rows
    x = torch.nn.functional.pad(x_codes.to(torch.float32), (0, k_pad - k))
    xg = x.reshape(m, g, rows)
    if planes is None:
        n = w_codes.shape[1]
        w = torch.nn.functional.pad(w_codes.to(torch.int32),
                                    (0, 0, 0, k_pad - k))
        wp = bitslice_weights(w, b).reshape(b, g, rows, n)
    elif planes.ndim == 3:  # packed plan planes: [G, rows, N] uint8
        wp = bitslice_weights(planes, b)  # [B, G, rows, N]
    else:  # unpacked plan planes: [G, B, rows, N]
        wp = planes.permute(1, 0, 2, 3)
    return xg, wp.to(torch.float32)


def _plane_signs_f32(weight_bits: int, device) -> torch.Tensor:
    return plane_signs(weight_bits, device).to(torch.float32)


def cim_matmul_ref(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig,
    *,
    planes: torch.Tensor | None = None,
) -> torch.Tensor:
    """[M, K] x [K, N] -> [M, N] float32, macro semantics, vectorized.

    ``planes`` optionally reuses a plan's pre-grouped bit planes (grouped
    at ``cfg.rows_active``) instead of re-slicing ``w_codes``.
    """
    xg, wp = _grouped_operands(x_codes, w_codes, cfg, planes)
    # Group pMACs are exact integers; the float64 contraction keeps them
    # so whatever the float32 matmul precision setting.
    pmac = torch.einsum(
        "mgr,bgrn->mgbn", xg.to(torch.float64), wp.to(torch.float64)
    ).to(torch.float32)
    half = 0.5 if getattr(cfg, "adc_mode", "floor") == "nearest" else 0.0
    code = torch.clamp(
        torch.floor(true_divide(pmac, cfg.adc_step) + half), 0, cfg.adc_codes - 1
    )  # [M, G, B, N]
    signs = _plane_signs_f32(cfg.weight_bits, x_codes.device)
    return (code * cfg.adc_step * signs[:, None]).sum(dim=(1, 2))


def _merged_codes(merged: torch.Tensor, cfg) -> tuple[torch.Tensor, float]:
    """Exact merged values -> clipped single-ADC codes (f32), and the step."""
    mq = merged_quant(cfg)
    half = 0.5 if getattr(cfg, "adc_mode", "floor") == "nearest" else 0.0
    code = torch.clamp(
        torch.floor(true_divide(merged, mq.step) + half),
        mq.code_min, mq.code_max,
    )
    return code, mq.step


def adder_tree_matmul_ref(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig,
    *,
    planes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Vectorized single-ADC merged transfer (adder-tree interface).

    Merge the plane partial-MACs in the charge domain (MSB negative),
    ONE conversion per (group, output), sum the dequantized group codes.
    """
    xg, wp = _grouped_operands(x_codes, w_codes, cfg, planes)
    # Merged values are exact integers (|merged| <= 2**(B-1) * pmac_max)
    # in float64 whatever the matmul precision setting.
    pmac = torch.einsum(
        "mgr,bgrn->mgbn", xg.to(torch.float64), wp.to(torch.float64)
    )
    signs = plane_signs(cfg.weight_bits, x_codes.device).to(torch.float64)
    merged = torch.einsum("mgbn,b->mgn", pmac, signs).to(torch.float32)
    code, step = _merged_codes(merged, cfg)
    return torch.sum(code, dim=1) * step


# ---------------------------------------------------------------------------
# Spread-slot formulation (the decode-shape "slots" backend)
# ---------------------------------------------------------------------------


def _slot_dot(x_codes, slots, spec):
    """[M, K] codes x [G, rows, S*N] slots -> combined [G, M, S*N] f32.

    The packed fields reach 2**24, so the contraction runs in float64,
    where it is exact whatever the float32 matmul precision setting
    (TF32 would drop the low fields); the exact sums then round-trip to
    float32 unchanged.
    """
    # bound: pmac_max * (stride**per_slot - 1) // (stride - 1) < 2**24
    m, k = x_codes.shape
    g, rows, sn = slots.shape
    if rows != spec.rows_active:
        raise ValueError(
            f"slots grouped at {rows} rows but spec.rows_active="
            f"{spec.rows_active}; re-plan (slots cannot be regrouped)"
        )
    if g * rows < k:
        raise ValueError(f"slots cover K={g * rows} < input K={k}")
    x = torch.nn.functional.pad(x_codes.to(torch.float64), (0, g * rows - k))
    xg = x.reshape(m, g, rows).transpose(0, 1)  # [G, M, rows]
    return torch.bmm(xg, slots.to(torch.float64)).to(torch.float32)


def _iter_slot_planes(
    combined, spec, ss
) -> Iterator[tuple[int, torch.Tensor]]:
    """Yield (plane index b, exact integer pMAC [G, M, N]) per plane."""
    b_total = spec.weight_bits
    inv = 1.0 / float(ss.stride)
    for s in range(ss.n_slots):
        cs = combined[..., s, :]
        lo = s * ss.per_slot
        for j in range(min(ss.per_slot, b_total - lo)):
            hi = torch.floor(cs * inv)
            yield lo + j, cs - hi * float(ss.stride)
            cs = hi


def _plane_sign(b: int, weight_bits: int) -> float:
    """Two's-complement shift-add weight of plane b, as a Python float."""
    s = float(1 << b)
    return -s if b == weight_bits - 1 else s


def _slot_geometry(slots, spec):
    ss = slot_spec(spec.rows_active, spec.act_bits, spec.weight_bits)
    if ss is None:
        raise ValueError(
            "spread slots infeasible at this operating point "
            f"(rows_active={spec.rows_active}, act_bits={spec.act_bits})"
        )
    sn = slots.shape[-1]
    if sn % ss.n_slots != 0:
        raise ValueError(
            f"slots last dim {sn} is not divisible by n_slots="
            f"{ss.n_slots}; operand packed for a different operating point"
        )
    return ss, sn // ss.n_slots


def cim_matmul_slots(
    x_codes: torch.Tensor,
    slots: torch.Tensor,
    cfg: CIMConfig,
) -> torch.Tensor:
    """P-8T per-plane transfer over spread-slot planes. [M,K] -> [M,N].

    ``slots`` is the plan's ``quant.spread_slots`` operand, grouped at
    ``cfg.rows_active``. Bit-exact vs :func:`cim_matmul_ref` for both
    adc modes; noiseless by definition.
    """
    # bound: G * 2**(weight_bits - 1) * threshold < 2**23 * adc_step
    ss, n = _slot_geometry(slots, cfg)
    g = slots.shape[0]
    m = x_codes.shape[0]
    c = _slot_dot(x_codes, slots, cfg).reshape(g, m, ss.n_slots, n)
    half = 0.5 if getattr(cfg, "adc_mode", "floor") == "nearest" else 0.0
    inv_step = 1.0 / float(cfg.adc_step)
    acc = torch.zeros((g, m, n), dtype=torch.float32, device=x_codes.device)
    for b, pmac in _iter_slot_planes(c, cfg, ss):
        code = torch.clamp(
            torch.floor(pmac * inv_step + half), 0, cfg.adc_codes - 1
        )
        acc = acc + code * (
            _plane_sign(b, cfg.weight_bits) * float(cfg.adc_step)
        )
    return torch.sum(acc, dim=0)


def adder_tree_matmul_slots(
    x_codes: torch.Tensor,
    slots: torch.Tensor,
    cfg: CIMConfig,
) -> torch.Tensor:
    """Merged single-ADC transfer over spread-slot planes: recover the
    per-plane pMACs, fold them through the charge-domain adder (MSB
    negative), ONE conversion per (group, output). Bit-exact vs
    :func:`adder_tree_matmul_ref`."""
    # bound: G * max(-code_min, code_max) < 2**24
    ss, n = _slot_geometry(slots, cfg)
    g = slots.shape[0]
    m = x_codes.shape[0]
    c = _slot_dot(x_codes, slots, cfg).reshape(g, m, ss.n_slots, n)
    merged = torch.zeros((g, m, n), dtype=torch.float32,
                         device=x_codes.device)
    for b, pmac in _iter_slot_planes(c, cfg, ss):
        merged = merged + pmac * _plane_sign(b, cfg.weight_bits)
    code, step = _merged_codes(merged, cfg)
    return torch.sum(code, dim=0) * step
