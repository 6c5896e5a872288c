"""The P-8T macro's noiseless digital reference for one macro cycle.

``macro_op_reference_digital`` is the integer oracle the voltage-domain
pipeline (``core.pipeline.default_pipeline``) equals when noise is off,
for every input and weight pattern; it is the P-8T variant's
``oracle_int``. The voltage-domain ``macro_op`` comes with slice 4 of
ROADMAP.md.
"""

from __future__ import annotations

import torch

from repro_torch.core import adc, quant
from repro_torch.core.params import CIMConfig


def macro_op_reference_digital(
    x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig
) -> torch.Tensor:
    """Noiseless digital macro cycle with the flash ADC's transfer.

    x_codes [rows_per_group] input codes, w_codes [rows_per_group, n_out]
    signed weight codes -> [n_out] float32 shift-add outputs.
    """
    x = x_codes.to(torch.int32)
    active = torch.arange(cfg.rows_per_group, device=x.device) \
        < cfg.rows_active
    x_act = torch.where(active, x, torch.zeros_like(x))
    planes = quant.bitslice_weights(w_codes, cfg.weight_bits)  # [B,16,O]
    pmac = torch.einsum("r,bro->bo", x_act.to(torch.int64),
                        planes.to(torch.int64))  # [B, O]
    code = adc.adc_transfer_int(pmac, cfg)
    pmac_hat = adc.adc_dequant(code, cfg)
    signs = quant.plane_signs(cfg.weight_bits, x.device).to(torch.float32)
    return torch.sum(pmac_hat * signs[:, None], dim=0)
