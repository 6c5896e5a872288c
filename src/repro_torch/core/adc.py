"""Integer-domain ADC transfer of the coarse-fine flash ADC.

The ADC compares the ABL voltage against in-SRAM reference columns
spaced one ``adc_step`` of pMAC apart; in the integer domain that is

  code = clip(floor(pMAC / step), 0, 2**adc_bits - 1)   ('floor')

with values above the cutoff threshold saturating to the top code (the
paper's partial-sum quantization). The voltage-domain models and the
reference-pattern programming come with the analog pipeline slice
(ROADMAP slice 4), as does hardware-noise injection.
"""

from __future__ import annotations

import torch

from repro_torch.core.params import CIMConfig
from repro_torch.core.quant import true_divide


def adc_transfer_int(
    pmac: torch.Tensor,
    cfg: CIMConfig,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """pMAC -> ADC code in the integer domain (int32).

    ``generator`` requests hardware-noise injection for a ``noisy``
    operating point, which this port does not carry yet: that request
    raises. A noisy config without a generator is noiseless, exactly as
    the reference treats a noisy config without a key.
    """
    if cfg.noisy and generator is not None:
        raise ValueError(
            "hardware-noise injection is not ported yet; it comes with "
            "slice 4 (calibration and the analog pipeline) of ROADMAP.md"
        )
    x = pmac.to(torch.float32)
    step = cfg.adc_step
    if cfg.adc_mode == "nearest":
        code = torch.floor(true_divide(x, step) + 0.5)
    else:
        code = torch.floor(true_divide(x, step))
    return torch.clamp(code, 0, cfg.adc_codes - 1).to(torch.int32)


def adc_dequant(code: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """Digital reconstruction: pMAC_hat = code * step."""
    return code.to(torch.float32) * cfg.adc_step
