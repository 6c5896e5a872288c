"""Voltage-domain model of one 256x80 P-8T SRAM CIM macro op.

One macro cycle (paper Fig. 4 / Fig. 5):
  Pch.    -> all CBL/iBL precharged to VDD
  DA conv -> 16 local arrays convert 16 4-bit inputs via BL charge sharing
  Mult.   -> P-8T cells multiply by the stored 1-bit weights
  Acc.    -> eACC shares the 16 CBLs of each column onto its ABL
  ADC     -> 4-bit coarse-fine flash against AMU_REF references
  Shift-add (digital) -> recombine 8 bit-planes into 8 outputs

``macro_op`` is a thin composition of the default AnalogPipeline stages
(core.pipeline); ``_macro_op_oracle`` is the monolithic form of the same
cycle, the ground truth the pipeline equals bit for bit when noiseless.
``macro_op_reference_digital`` is the integer oracle both equal when
noise is off, for every input and weight pattern; it is the P-8T
variant's ``oracle_int``. All three are deliberately unoptimized.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import adc, dac, quant
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import AnalogPipeline, MacroSpec


class MacroOut(NamedTuple):
    outputs: torch.Tensor  # [n_outputs] f32 shift-add results
    adc_codes: torch.Tensor  # [n_outputs, weight_bits] int32
    v_abl: torch.Tensor  # [n_outputs, weight_bits] f32 column ABL voltages
    pmac_ideal: torch.Tensor  # [n_outputs, weight_bits] int32 noiseless pMAC


def macro_op(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig | MacroSpec,
    *,
    generator: torch.Generator | None = None,
    pipeline: AnalogPipeline | None = None,
) -> MacroOut:
    """Run one macro cycle in the voltage domain.

    Args:
      x_codes: [rows_per_group] 4-bit input codes (rows beyond
        rows_active are masked to 0).
      w_codes: [rows_per_group, n_outputs] signed weight codes
        (weight_bits wide), bit-sliced across the weight columns.
      cfg: operating point (CIMConfig or MacroSpec).
      generator: hardware-error source when ``cfg.noisy`` (DAC draws,
        then ADC offsets, from this one generator).
      pipeline: stage composition to run; default the paper's macro
        (DAC -> AMU -> ADC -> shift-add).

    Returns MacroOut with outputs = sum_b sign_b 2^b dequant(code_b).
    """
    pipe = pipeline if pipeline is not None else \
        pipeline_lib.default_pipeline()
    state = pipe.run(x_codes, w_codes, cfg, generator=generator)
    return MacroOut(
        outputs=state.outputs,
        adc_codes=state.adc_codes,
        v_abl=state.v_abl,
        pmac_ideal=state.pmac_ideal,
    )


def _macro_op_oracle(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: CIMConfig,
    *,
    generator: torch.Generator | None = None,
) -> MacroOut:
    """The monolithic macro cycle: the oracle the default AnalogPipeline
    equals bit for bit (and, with one generator, draw for draw: the DAC's
    row errors first, then the ADC's offsets)."""
    n = cfg.rows_per_group
    if tuple(x_codes.shape) != (n,):
        raise ValueError(f"x_codes must be [{n}], got {tuple(x_codes.shape)}")
    # Inactive rows' local arrays are not activated: their CBLs stay at
    # VDD (value 0), as for x = 0.
    x = x_codes.to(torch.int32)
    active = torch.arange(n, device=x.device) < cfg.rows_active
    x_act = torch.where(active, x, torch.zeros_like(x))
    v_rows = dac.dac_voltage(x_act, cfg, generator=generator)  # [16]

    planes = quant.bitslice_weights(w_codes, cfg.weight_bits)
    # planes [B, 16, n_out] -> columns [16, n_out, B]
    w_cols = torch.movedim(planes, 0, -1).to(torch.float32)
    v_cbl = dac.multiply_bitcell(v_rows[:, None, None], w_cols, cfg)
    v_abl = dac.accumulate_abl(torch.movedim(v_cbl, 0, -1), cfg)

    code = adc.adc_read_voltage(v_abl, cfg, generator=generator)
    pmac_hat = adc.adc_dequant(code, cfg)
    signs = quant.plane_signs(cfg.weight_bits, x.device).to(torch.float32)
    outputs = torch.sum(pmac_hat * signs[None, :], dim=-1)
    pmac_ideal = quant.plane_pmacs(x_act, planes).T.to(torch.int32)
    return MacroOut(
        outputs=outputs.to(torch.float32),
        adc_codes=code,
        v_abl=v_abl,
        pmac_ideal=pmac_ideal,
    )


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
    pmac = quant.plane_pmacs(x_act, planes)  # [B, O]
    code = adc.adc_transfer_int(pmac, cfg)
    pmac_hat = adc.adc_dequant(code, cfg)
    signs = quant.plane_signs(cfg.weight_bits, x.device).to(torch.float32)
    return torch.sum(pmac_hat * signs[:, None], dim=0)
