"""Voltage-domain model of the BL charge-sharing DAC (paper Sec. III.A).

The AMU's 16 CBL capacitors are grouped binary-weighted:
  8 caps <- X[3], 4 caps <- X[2], 2 caps <- X[1], 1 cap <- X[0],
  1 cap always precharged.
Input bit X[i] = 1 discharges its group to GND; charge sharing across all
16 equal caps then yields

  V_DAC = (sum_i 2**i * ~X[i] + 1) * VDD / 16 = (16 - X) / 16 * VDD.

Value encoding used throughout: value(V) = 16 * (1 - V/VDD), so
value(V_DAC) = X and V = VDD encodes 0.

Every function takes the operating point by attribute access only, so
``cfg`` may be a flat ``CIMConfig`` or a ``core.pipeline.MacroSpec``.

Hardware noise: a ``noisy`` operating point with a ``torch.Generator``
draws Gaussian errors from that generator (the JAX package's PRNG keys
become generators; torch cannot replay the reference's stream, so noisy
paths agree with it in distribution, not draw for draw). A noisy point
without a generator is noiseless, as the reference is without a key.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import true_divide


def standard_normal(shape, generator: torch.Generator,
                    device) -> torch.Tensor:
    """float32 N(0, 1) draws of ``shape`` on ``device`` from
    ``generator``, which must live on that device (a CUDA generator fills
    CUDA tensors only)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"a {generator.device.type} generator cannot draw noise for "
            f"a tensor on {device}; create it with torch.Generator("
            f"device={device.type!r})")
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def cap_states(x_code: torch.Tensor, cfg) -> torch.Tensor:
    """Per-capacitor post-evaluation voltages, in units of VDD.

    x_code: integer tensor of 4-bit codes, any shape [...].
    Returns [..., 16] float32 with entries in {0, 1}: cap j is
    discharged iff it belongs to the group of a set input bit. Caps
    0..7 <- X[3], 8..11 <- X[2], 12..13 <- X[1], 14 <- X[0], cap 15
    always precharged.
    """
    n = cfg.rows_per_group
    owner: list[int] = []
    for b in range(cfg.act_bits - 1, -1, -1):  # MSB first: sizes 8, 4, 2, 1
        owner.extend([b] * (1 << b))
    owner.extend([-1] * (n - len(owner)))  # always-precharged remainder
    owner_t = torch.tensor(owner, dtype=torch.int32, device=x_code.device)
    x = x_code.to(torch.int32)[..., None]
    bit = torch.bitwise_and(
        torch.bitwise_right_shift(x, torch.clamp(owner_t, min=0)), 1
    )
    bit_set = torch.where(owner_t >= 0, bit, torch.zeros_like(bit))
    return 1.0 - bit_set.to(torch.float32)


def dac_voltage(
    x_code: torch.Tensor, cfg, *, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Shared CBL/iBL voltage after the eDAC charge-sharing phase.

    Exactly (16 - X)/16 * VDD when noiseless. With ``cfg.noisy`` and a
    generator, one Gaussian error per conversion (paper Fig. 9a: worst
    case sigma 1.8 mV at 0.6 V, scaled with vdd) is added in the voltage
    domain, drawn in one call of x_code's shape.
    """
    v = torch.mean(cap_states(x_code, cfg), dim=-1) * cfg.vdd
    if cfg.noisy and generator is not None:
        sigma_v = cfg.sigma_dac_mv * 1e-3 * (cfg.vdd / 0.6)
        v = v + sigma_v * standard_normal(v.shape, generator, v.device)
    return v


def dac_value(v: torch.Tensor, cfg) -> torch.Tensor:
    """Map a CBL voltage back to the value domain: 16 * (1 - V/VDD)."""
    return cfg.rows_per_group * (1.0 - true_divide(v, cfg.vdd))


def multiply_bitcell(
    v_cbl: torch.Tensor, w_bit: torch.Tensor, cfg
) -> torch.Tensor:
    """P-8T multiplication phase (Fig. 3c / Fig. 4 truth table).

    w=1: P0 off, CBL preserves V_DAC.  w=0: P0 on, CBL charged to VDD
    (value 0). Voltage in, voltage out.
    """
    w = w_bit.to(v_cbl.dtype)
    return w * v_cbl + (1.0 - w) * cfg.vdd


def accumulate_abl(v_cbls: torch.Tensor, cfg) -> torch.Tensor:
    """ABL charge-sharing accumulation over the last (group) axis:
    V_ABL = (sum_j C*V_j + C_ABL*VDD) / (16*C + C_ABL)  (Fig. 5(b))."""
    n = cfg.rows_per_group
    kappa = cfg.c_abl_ratio
    return true_divide(torch.sum(v_cbls, dim=-1) + kappa * cfg.vdd,
                       n + kappa)


def abl_voltage_from_pmac(pmac: torch.Tensor, cfg) -> torch.Tensor:
    """Ideal equation of Fig. 5(b): V_ABL = VDD * (1 - pMAC/denom)."""
    return cfg.vdd * (1.0 - true_divide(pmac, cfg.share_denom))


def pmac_from_abl_voltage(v_abl: torch.Tensor, cfg) -> torch.Tensor:
    return (1.0 - true_divide(v_abl, cfg.vdd)) * cfg.share_denom
