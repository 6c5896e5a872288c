"""Monte-Carlo hardware-error studies (paper Figs. 5b, 9a and Sec. IV).

The paper characterizes analog non-idealities with 10K-sample Monte-Carlo
circuit simulations and then injects them into system simulations. These
studies mirror that: voltage-domain sigmas (DAC charge-sharing variation,
comparator offset) are sampled here and folded into the pMAC domain for
the behavioral model (``CIMConfig.sigma_pmac``).

Every study takes a flat ``CIMConfig`` or a ``core.pipeline.MacroSpec``
and a ``seed``, which becomes one ``torch.Generator`` on ``device``
(default the card); all samples are drawn from it in one call per study,
sample-major. The reference vmaps over keys split from its seed instead,
so the two agree in distribution, not draw for draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import adc, dac
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import MacroSpec

OpPoint = CIMConfig | MacroSpec


class MCResult(NamedTuple):
    codes: torch.Tensor  # swept DAC codes (or pMAC levels) [L]
    mean_v: torch.Tensor  # mean voltage per code [L]
    std_v: torch.Tensor  # std-dev per code [L]
    ideal_v: torch.Tensor  # ideal equation voltage [L]


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _stats(codes, vs, ideal) -> MCResult:
    # Population std-dev (ddof 0), as jnp.std.
    return MCResult(codes, torch.mean(vs, 0), torch.std(vs, 0, correction=0),
                    ideal)


def mc_dac_linearity(
    cfg: OpPoint, *, n_samples: int = 10_000, seed: int = 0,
    device="cuda",
) -> MCResult:
    """Fig. 9(a): Monte-Carlo DAC transfer across all input codes."""
    noisy_cfg = cfg.replace(noisy=True)
    codes = torch.arange(noisy_cfg.act_levels, dtype=torch.int32,
                         device=device)
    vs = dac.dac_voltage(codes.expand(n_samples, -1), noisy_cfg,
                         generator=_generator(seed, device))  # [S, L]
    ideal = noisy_cfg.vdd * (noisy_cfg.act_levels - codes.to(torch.float32)) \
        / noisy_cfg.act_levels
    return _stats(codes, vs, ideal)


def mc_accumulation_linearity(
    cfg: OpPoint, *, n_samples: int = 10_000, seed: int = 0,
    device="cuda",
) -> MCResult:
    """Fig. 5(b): V_ABL Monte-Carlo against the ideal equation over pMAC.

    Sweeps pMAC by driving every active row with the same input code and
    weight '1', so pMAC = rows_active * code; each sample perturbs the
    per-CBL DAC voltages independently.
    """
    noisy_cfg = cfg.replace(noisy=True)
    n = noisy_cfg.rows_per_group
    codes = torch.arange(noisy_cfg.act_levels, dtype=torch.int32,
                         device=device)
    pmac = codes * noisy_cfg.rows_active
    # Per-row DAC conversions, independent noise per CBL: [S, L, rows].
    v_rows = dac.dac_voltage(codes[None, :, None].expand(n_samples, -1, n),
                             noisy_cfg, generator=_generator(seed, device))
    active = (torch.arange(n, device=device) < noisy_cfg.rows_active)
    w = active.to(torch.float32).expand_as(v_rows)
    v_cbl = dac.multiply_bitcell(v_rows, w, noisy_cfg)
    vs = dac.accumulate_abl(v_cbl, noisy_cfg)  # [S, L]
    ideal = dac.abl_voltage_from_pmac(pmac.to(torch.float32), noisy_cfg)
    return _stats(pmac, vs, ideal)


def mc_adc_split_error_rate(
    cfg: OpPoint,
    coarse_bits: int,
    *,
    n_samples: int = 4_096,
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """P(code error) per pMAC level for one coarse/fine readout split.

    Drives the voltage-domain comparator readout (per-comparator Gaussian
    offsets) at the given split. All splits decode identical codes
    noiselessly, and under offsets their error profiles stay
    statistically indistinguishable (the same reference crossings decide
    every split), which is why the calibration sweep prices the split by
    comparator count alone.
    """
    noisy_cfg = cfg.replace(noisy=True)
    pmac = torch.arange(noisy_cfg.pmac_levels, dtype=torch.float32,
                        device=device)
    v = dac.abl_voltage_from_pmac(pmac, noisy_cfg)
    ideal = adc.adc_read_voltage(v, cfg.replace(noisy=False),
                                 coarse_bits=coarse_bits)
    code = adc.adc_read_voltage(v.expand(n_samples, -1), noisy_cfg,
                                generator=_generator(seed, device),
                                coarse_bits=coarse_bits)
    return torch.mean((code != ideal).to(torch.float32), dim=0)


def mc_adc_error_rate(
    cfg: OpPoint, *, n_samples: int = 4_096, seed: int = 0, device="cuda",
) -> torch.Tensor:
    """Probability of an ADC code error per pMAC level under hardware
    noise: [pmac_levels] P(code != ideal_code)."""
    noisy_cfg = cfg.replace(noisy=True)
    pmac = torch.arange(noisy_cfg.pmac_levels, dtype=torch.float32,
                        device=device)
    ideal_code = adc.adc_transfer_int(pmac, cfg.replace(noisy=False))
    code = adc.adc_transfer_int(pmac.expand(n_samples, -1), noisy_cfg,
                                generator=_generator(seed, device))
    return torch.mean((code != ideal_code).to(torch.float32), dim=0)
