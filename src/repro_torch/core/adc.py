"""The 4-bit coarse-fine flash ADC with in-SRAM reference generation.

Paper Sec. III.B: 16 AMU_REF columns run the same charge-sharing pipeline
as the compute columns. With the reference input pattern '1000' (code 8,
half-VDD after DA conversion) and N of the 16 local arrays storing '1':

  V_REF[N] = (N/2 + (16 - N)) * VDD / 16  <->  pMAC = 8N.

Readout is 1-bit coarse (compare against REF[8]) + 3-bit fine flash (7
comparators), 8 comparators in all against 15 for a plain 4-bit flash.
In the integer domain the transfer is

  code = clip(floor(pMAC / step), 0, 2**adc_bits - 1)   ('floor')

with values above the cutoff threshold saturating to the top code (the
paper's partial-sum quantization). A ``noisy`` operating point with a
``torch.Generator`` injects hardware errors: comparator offsets in the
voltage-domain readout, the folded pMAC-domain sigma in the integer
transfer.
"""

from __future__ import annotations

import torch

from repro_torch.core import dac
from repro_torch.core.params import CIMConfig
from repro_torch.core.quant import true_divide


def reference_input_code(cfg: CIMConfig) -> int:
    """Reference DAC input whose value equals the ADC step in pMAC units
    (pattern '1000' = 8 at the paper's 16-row point). A non-integer step
    has no in-SRAM reference spacing and raises."""
    step = cfg.adc_step
    if abs(step - round(step)) > 1e-9:
        raise ValueError(
            f"adc_step={step} is not an integer pMAC spacing; choose "
            "cutoff/adc_bits so threshold is a multiple of 2**adc_bits"
        )
    return int(round(step))


def reference_patterns(cfg: CIMConfig) -> list[list[int]]:
    """Per-level AMU_REF programming: the iBL input code of each of the
    ``rows_per_group`` local arrays, with sum(codes) = N * adc_step.

    The paper's homogeneous pattern (``[step]*N + [0]*rest``) wherever
    it fits (step <= act_max and N <= rows_per_group); elsewhere a
    greedy act_max-first fill of per-row codes. Raises when a level
    needs more reference charge than the arrays can sink.
    """
    # bound: (adc_codes - 1) * adc_step <= rows_per_group * act_max
    step = reference_input_code(cfg)
    rows = cfg.rows_per_group
    patterns: list[list[int]] = []
    for n_level in range(cfg.adc_codes):
        target = n_level * step
        if target > rows * cfg.act_max:
            raise ValueError(
                f"reference level pMAC={target} not representable: "
                f"exceeds {rows} arrays x act_max={cfg.act_max}"
            )
        if step <= cfg.act_max and n_level <= rows:
            row = [step] * n_level  # the paper's homogeneous pattern
        else:
            q, r = divmod(target, cfg.act_max)
            row = [cfg.act_max] * q + ([r] if r else [])
        patterns.append(row + [0] * (rows - len(row)))
    return patterns


def reference_voltages(cfg: CIMConfig, device=None) -> torch.Tensor:
    """V_REF[N] for N = 0..(2**adc_bits - 1) through the AMU_REF
    pipeline: each local array DA-converts its reference code, arrays
    with a nonzero code store '1', then ABL charge sharing (the compute
    columns' own code path, so kappa and VDD cancel in the compare)."""
    patterns = torch.tensor(reference_patterns(cfg), dtype=torch.int32,
                            device=device)
    v_dac = dac.dac_voltage(patterns, cfg)  # [n_codes, rows]
    stored = (patterns > 0).to(torch.float32)
    v_cbl = dac.multiply_bitcell(v_dac, stored, cfg)
    return dac.accumulate_abl(v_cbl, cfg)  # [n_codes]


def adc_read_voltage(
    v_abl: torch.Tensor,
    cfg: CIMConfig,
    *,
    generator: torch.Generator | None = None,
    coarse_bits: int | None = None,
) -> torch.Tensor:
    """Coarse-fine comparator readout of an ABL voltage -> int32 code.

    code = #{N >= 1 : V_ABL <= V_REF[N]} (lower voltage = larger pMAC),
    read as ``coarse_bits`` of segment index from the segment-boundary
    comparators, then the fine bits inside the selected segment. Every
    split gives the same codes; ``coarse_bits=None`` reads
    ``cfg.adc_coarse_bits``.
    """
    if coarse_bits is None:
        coarse_bits = getattr(cfg, "adc_coarse_bits", 1)
    if not (0 <= coarse_bits <= cfg.adc_bits):
        raise ValueError(
            f"coarse_bits={coarse_bits} out of range [0, {cfg.adc_bits}]"
        )
    vrefs = reference_voltages(cfg, v_abl.device)  # decreasing in N
    # Ties at an exact reference crossing resolve toward "above
    # reference" with an epsilon far below one LSB.
    eps = cfg.vdd * 1e-6
    levels = vrefs + eps
    if cfg.noisy and generator is not None:
        # One input-referred offset per comparator and conversion, drawn
        # in one call of shape v_abl.shape + (2**bits,).
        sigma_v = cfg.sigma_cmp_mv * 1e-3 * (cfg.vdd / 0.6)
        levels = levels + sigma_v * dac.standard_normal(
            (*v_abl.shape, vrefs.shape[0]), generator, v_abl.device)
    fine_codes = 1 << (cfg.adc_bits - coarse_bits)
    cmp_all = v_abl[..., None] <= levels  # [..., 2**bits]
    boundaries = fine_codes * torch.arange(1, 1 << coarse_bits,
                                           device=v_abl.device)
    seg = torch.sum(cmp_all[..., boundaries].to(torch.int32), dim=-1)
    base = seg * fine_codes
    offsets = torch.arange(1, fine_codes, device=v_abl.device)
    idx = base[..., None] + offsets  # [..., fine_codes - 1]
    fine = torch.sum(
        torch.take_along_dim(cmp_all, idx, dim=-1).to(torch.int32), dim=-1
    )
    return (base + fine).to(torch.int32)


def adc_flat_flash(v_abl: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """Conventional 15-comparator flash (noiseless), for equivalence tests."""
    vrefs = reference_voltages(cfg, v_abl.device)
    eps = cfg.vdd * 1e-6
    return torch.sum(v_abl[..., None] <= vrefs[1:] + eps,
                     dim=-1).to(torch.int32)


def adc_transfer_int(
    pmac: torch.Tensor,
    cfg: CIMConfig,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """pMAC -> ADC code in the integer domain (int32).

    With ``cfg.noisy`` and a generator, Gaussian noise of ``sigma_pmac``
    (the voltage-domain sigmas folded into pMAC units) is added first,
    one draw per element of ``pmac`` -- how the paper's hardware-aware
    system simulations inject PVT and comparator errors. A noisy config
    without a generator is noiseless, as the reference is without a key.
    """
    x = pmac.to(torch.float32)
    if cfg.noisy and generator is not None:
        x = x + cfg.sigma_pmac * dac.standard_normal(x.shape, generator,
                                                     x.device)
    step = cfg.adc_step
    if cfg.adc_mode == "nearest":
        code = torch.floor(true_divide(x, step) + 0.5)
    else:
        code = torch.floor(true_divide(x, step))
    return torch.clamp(code, 0, cfg.adc_codes - 1).to(torch.int32)


def adc_dequant(code: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """Digital reconstruction: pMAC_hat = code * step."""
    return code.to(torch.float32) * cfg.adc_step
