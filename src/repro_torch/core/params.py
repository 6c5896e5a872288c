"""Configuration for the P-8T SRAM CIM macro model.

Every geometry and operating-point number defaults to the paper's
implementation: a 256x80 macro built from 16x5 AMUs, 16 local arrays per
accumulation bit-line (ABL), 4-bit activations, 8-bit bit-sliced weights,
a 4-bit coarse-fine flash ADC, cutoff 0.5, supply 0.6-1.2 V.

A frozen dataclass, so it hashes and can key caches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

ADCMode = Literal["floor", "nearest"]


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Operating point of one P-8T SRAM CIM macro.

    Attributes:
      rows_per_group: local arrays sharing one ABL (hardware constant: 16).
      rows_active: activated rows per accumulation (paper sweeps 4/8/16).
      act_bits: input activation precision (paper: 4).
      weight_bits: weight precision, bit-sliced across columns (paper: 8).
      adc_bits: flash ADC resolution (paper: 4, coarse-fine).
      cutoff: partial-sum cutoff; threshold = (1 - cutoff) * 2**q_full
        (cutoff 0.5 -> Th=128 of the 241-level pMAC space at 16 rows,
        ADC step 8).
      adc_mode: 'floor' reproduces comparator semantics; 'nearest' is a
        beyond-paper readout option.
      adc_coarse_bits: coarse/fine split of the flash readout (paper: 1).
        Every split yields identical codes; only hardware cost moves.
      vdd: supply voltage in volts (paper range 0.6-1.2).
      sigma_dac_mv: DAC (CBL charge-sharing) std-dev in mV at 0.6 V.
      sigma_cmp_mv: comparator input-referred offset std-dev in mV.
      c_abl_ratio: kappa = C_ABL / C_CBL parasitic ratio.
      noisy: enable hardware-error injection.
      macro_rows/macro_cols: physical array geometry (256 x 80).
      n_ref_cols: AMU_REF columns used for ADC reference generation (16).
    """

    rows_per_group: int = 16
    rows_active: int = 16
    act_bits: int = 4
    weight_bits: int = 8
    adc_bits: int = 4
    cutoff: float = 0.5
    adc_mode: ADCMode = "floor"
    adc_coarse_bits: int = 1
    vdd: float = 0.9
    sigma_dac_mv: float = 1.8
    sigma_cmp_mv: float = 2.0
    c_abl_ratio: float = 0.0
    noisy: bool = False
    macro_rows: int = 256
    macro_cols: int = 80
    n_ref_cols: int = 16

    def __post_init__(self) -> None:
        if self.rows_active > self.rows_per_group:
            raise ValueError(
                f"rows_active={self.rows_active} exceeds rows_per_group="
                f"{self.rows_per_group}"
            )
        if self.rows_active < 1:
            raise ValueError("rows_active must be >= 1")
        if not (1 <= self.adc_bits <= self.q_full):
            raise ValueError(
                f"adc_bits={self.adc_bits} out of range [1, {self.q_full}]"
            )
        if not (0.0 <= self.cutoff < 1.0):
            raise ValueError(f"cutoff={self.cutoff} must be in [0, 1)")
        if not (0 <= self.adc_coarse_bits <= self.adc_bits):
            raise ValueError(
                f"adc_coarse_bits={self.adc_coarse_bits} out of range "
                f"[0, {self.adc_bits}]"
            )
        if self.act_bits < 1 or self.weight_bits < 1:
            raise ValueError("act_bits and weight_bits must be >= 1")

    # ---- derived quantities (paper Sec. III / IV nomenclature) ----

    @property
    def act_levels(self) -> int:
        """Input DAC levels (16 for 4-bit)."""
        return 1 << self.act_bits

    @property
    def act_max(self) -> int:
        """Maximum activation code (15 for 4-bit)."""
        return self.act_levels - 1

    @property
    def pmac_max(self) -> int:
        """Maximum partial-MAC value: rows_active * act_max (240 at 16 rows)."""
        return self.rows_active * self.act_max

    @property
    def pmac_levels(self) -> int:
        return self.pmac_max + 1

    @property
    def q_full(self) -> int:
        """ADC resolution needed for exact pMAC readout (paper's q)."""
        return max(1, math.ceil(math.log2(self.pmac_levels)))

    @property
    def threshold(self) -> int:
        """Cutoff threshold in pMAC units: (1 - cutoff) * 2**q_full."""
        return max(1, int(round((1.0 - self.cutoff) * (1 << self.q_full))))

    @property
    def adc_step(self) -> float:
        """ADC LSB in pMAC units (threshold / 2**adc_bits = 8)."""
        return self.threshold / (1 << self.adc_bits)

    @property
    def adc_codes(self) -> int:
        return 1 << self.adc_bits

    @property
    def share_denom(self) -> float:
        """Charge-sharing denominator 16 * (16 + kappa) mapping pMAC->V."""
        return self.rows_per_group * (self.rows_per_group + self.c_abl_ratio)

    @property
    def sigma_pmac(self) -> float:
        """Total analog noise std-dev expressed in pMAC units.

        The ABL charge share averages the rows_active per-CBL DAC errors
        (sqrt(rows_active) / rows_per_group); the comparator offset
        applies once at the ADC input. Sigmas scale with vdd, so the
        pMAC-domain sigma is vdd-independent to first order.
        """
        scale = self.vdd / 0.6
        sigma_dac_v = self.sigma_dac_mv * 1e-3 * scale
        sigma_cmp_v = self.sigma_cmp_mv * 1e-3 * scale
        dac_term = (
            sigma_dac_v * math.sqrt(self.rows_active) / self.rows_per_group
        ) ** 2
        cmp_term = sigma_cmp_v**2
        return math.sqrt(dac_term + cmp_term) * self.share_denom / self.vdd

    @property
    def codes_dtype(self) -> torch.dtype:
        """Narrowest int dtype holding signed weight codes (int8 at 8 bits)."""
        return torch.int8 if self.weight_bits <= 8 else torch.int32

    @property
    def n_weight_cols(self) -> int:
        """Columns carrying weight bit-planes (80 - 16 ref = 64)."""
        return self.macro_cols - self.n_ref_cols

    @property
    def n_outputs(self) -> int:
        """Output channels per macro (64 cols / 8 bit-planes = 8)."""
        return self.n_weight_cols // self.weight_bits

    @property
    def macs_per_cycle(self) -> int:
        """MACs completed per macro cycle (paper: 16 x 8 = 128)."""
        return self.rows_per_group * self.n_outputs

    @property
    def comparator_count(self) -> int:
        """Comparators per conversion for the coarse/fine split."""
        from repro_torch.core.pipeline import ADCSpec  # pipeline imports us

        return ADCSpec(
            bits=self.adc_bits, cutoff=self.cutoff,
            coarse_bits=self.adc_coarse_bits,
        ).comparator_count

    def replace(self, **kw) -> "CIMConfig":
        return dataclasses.replace(self, **kw)

    def to_spec(self):
        """The declarative MacroSpec form of this operating point."""
        from repro_torch.core.pipeline import MacroSpec

        return MacroSpec.from_config(self)


# The paper's published operating points.
PAPER_OP_16ROWS = CIMConfig(rows_active=16, cutoff=0.5, adc_bits=4)
PAPER_OP_8ROWS = CIMConfig(rows_active=8, cutoff=0.5, adc_bits=4)
