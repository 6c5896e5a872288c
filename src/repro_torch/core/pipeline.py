"""Declarative operating-point records of the analog macro pipeline.

The macro cycle (DA conversion -> multiply/accumulate -> ADC ->
shift-add) is described by a :class:`MacroSpec`: a composition of
per-stage specs (:class:`DACSpec`, :class:`AMUSpec`, :class:`ADCSpec`).
``MacroSpec`` is attribute-compatible with ``CIMConfig`` (same derived
quantities), so every consumer of an operating point takes either;
``MacroSpec.from_config`` / ``to_config`` convert losslessly.

Only the spec records are here; the pipeline stages themselves come
with the analog pipeline slice (ROADMAP slice 4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.params import ADCMode, CIMConfig


@dataclasses.dataclass(frozen=True)
class DACSpec:
    """BL charge-sharing DAC. ``sigma_mv`` is specified at 0.6 V."""

    act_bits: int = 4
    vdd: float = 0.9
    sigma_mv: float = 1.8


@dataclasses.dataclass(frozen=True)
class AMUSpec:
    """16-local-array multiply + eACC accumulation unit."""

    rows_per_group: int = 16
    rows_active: int = 16
    c_abl_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class ADCSpec:
    """Coarse-fine flash ADC against AMU_REF columns.

    ``coarse_bits`` resolves that many bits of segment index with
    ``2**coarse_bits - 1`` boundary comparators, then the fine bits with
    ``2**(bits - coarse_bits) - 1`` comparators inside the segment.
    """

    bits: int = 4
    cutoff: float = 0.5
    coarse_bits: int = 1
    mode: ADCMode = "floor"
    sigma_cmp_mv: float = 2.0

    @property
    def comparator_count(self) -> int:
        """Comparators per conversion for this coarse/fine split."""
        fine = self.bits - self.coarse_bits
        return ((1 << self.coarse_bits) - 1) + ((1 << fine) - 1)


@dataclasses.dataclass(frozen=True)
class MacroSpec:
    """Declarative operating point of one macro: a DAC, an AMU, an ADC.

    Validation and every derived quantity live in ``CIMConfig``: the
    flat form is built (and validated) once in ``__post_init__`` and the
    derived properties read through it.
    """

    dac: DACSpec = dataclasses.field(default_factory=DACSpec)
    amu: AMUSpec = dataclasses.field(default_factory=AMUSpec)
    adc: ADCSpec = dataclasses.field(default_factory=ADCSpec)
    weight_bits: int = 8
    noisy: bool = False
    macro_rows: int = 256
    macro_cols: int = 80
    n_ref_cols: int = 16

    def __post_init__(self) -> None:
        # Direct __dict__ write: the dataclass is frozen and the cache is
        # not a field, so eq/hash/replace are unaffected.
        self.__dict__["_flat"] = CIMConfig(
            rows_per_group=self.amu.rows_per_group,
            rows_active=self.amu.rows_active,
            act_bits=self.dac.act_bits,
            weight_bits=self.weight_bits,
            adc_bits=self.adc.bits,
            cutoff=self.adc.cutoff,
            adc_mode=self.adc.mode,
            adc_coarse_bits=self.adc.coarse_bits,
            vdd=self.dac.vdd,
            sigma_dac_mv=self.dac.sigma_mv,
            sigma_cmp_mv=self.adc.sigma_cmp_mv,
            c_abl_ratio=self.amu.c_abl_ratio,
            noisy=self.noisy,
            macro_rows=self.macro_rows,
            macro_cols=self.macro_cols,
            n_ref_cols=self.n_ref_cols,
        )

    # ---- CIMConfig-compatible flat views --------------------------------

    @property
    def rows_per_group(self) -> int:
        return self.amu.rows_per_group

    @property
    def rows_active(self) -> int:
        return self.amu.rows_active

    @property
    def c_abl_ratio(self) -> float:
        return self.amu.c_abl_ratio

    @property
    def act_bits(self) -> int:
        return self.dac.act_bits

    @property
    def vdd(self) -> float:
        return self.dac.vdd

    @property
    def sigma_dac_mv(self) -> float:
        return self.dac.sigma_mv

    @property
    def adc_bits(self) -> int:
        return self.adc.bits

    @property
    def cutoff(self) -> float:
        return self.adc.cutoff

    @property
    def adc_mode(self) -> ADCMode:
        return self.adc.mode

    @property
    def adc_coarse_bits(self) -> int:
        return self.adc.coarse_bits

    @property
    def sigma_cmp_mv(self) -> float:
        return self.adc.sigma_cmp_mv

    # ---- derived quantities (delegated to the cached CIMConfig) ---------

    @property
    def act_levels(self) -> int:
        return self._flat.act_levels

    @property
    def act_max(self) -> int:
        return self._flat.act_max

    @property
    def pmac_max(self) -> int:
        return self._flat.pmac_max

    @property
    def pmac_levels(self) -> int:
        return self._flat.pmac_levels

    @property
    def q_full(self) -> int:
        return self._flat.q_full

    @property
    def threshold(self) -> int:
        return self._flat.threshold

    @property
    def adc_step(self) -> float:
        return self._flat.adc_step

    @property
    def adc_codes(self) -> int:
        return self._flat.adc_codes

    @property
    def share_denom(self) -> float:
        return self._flat.share_denom

    @property
    def sigma_pmac(self) -> float:
        return self._flat.sigma_pmac

    @property
    def codes_dtype(self) -> torch.dtype:
        return self._flat.codes_dtype

    @property
    def n_weight_cols(self) -> int:
        return self._flat.n_weight_cols

    @property
    def n_outputs(self) -> int:
        return self._flat.n_outputs

    @property
    def macs_per_cycle(self) -> int:
        return self._flat.macs_per_cycle

    @property
    def _flat(self) -> CIMConfig:
        return self.__dict__["_flat"]

    # ---- conversion / evolution ----------------------------------------

    @classmethod
    def from_config(cls, cfg: "CIMConfig | MacroSpec") -> "MacroSpec":
        if isinstance(cfg, MacroSpec):
            return cfg
        return cls(
            dac=DACSpec(
                act_bits=cfg.act_bits,
                vdd=cfg.vdd,
                sigma_mv=cfg.sigma_dac_mv,
            ),
            amu=AMUSpec(
                rows_per_group=cfg.rows_per_group,
                rows_active=cfg.rows_active,
                c_abl_ratio=cfg.c_abl_ratio,
            ),
            adc=ADCSpec(
                bits=cfg.adc_bits,
                cutoff=cfg.cutoff,
                coarse_bits=getattr(cfg, "adc_coarse_bits", 1),
                mode=cfg.adc_mode,
                sigma_cmp_mv=cfg.sigma_cmp_mv,
            ),
            weight_bits=cfg.weight_bits,
            noisy=cfg.noisy,
            macro_rows=cfg.macro_rows,
            macro_cols=cfg.macro_cols,
            n_ref_cols=cfg.n_ref_cols,
        )

    def to_config(self) -> CIMConfig:
        return self._flat

    _DAC_KEYS = frozenset({"act_bits", "vdd"})
    _AMU_KEYS = frozenset({"rows_per_group", "rows_active", "c_abl_ratio"})
    _ADC_KEYS = frozenset({"adc_bits", "cutoff", "coarse_bits", "adc_mode",
                           "sigma_cmp_mv"})

    def replace(self, **kw) -> "MacroSpec":
        """Evolve with flat CIMConfig-style keys or nested specs."""
        dac_kw, amu_kw, adc_kw, top_kw = {}, {}, {}, {}
        rename = {"adc_bits": "bits", "adc_mode": "mode",
                  "sigma_dac_mv": "sigma_mv", "adc_coarse_bits": "coarse_bits"}
        for k, v in kw.items():
            kk = rename.get(k, k)
            if k in ("dac", "amu", "adc"):
                top_kw[k] = v
            elif k in self._DAC_KEYS or k == "sigma_dac_mv":
                dac_kw[kk] = v
            elif k in self._AMU_KEYS:
                amu_kw[kk] = v
            elif k in self._ADC_KEYS or k == "adc_coarse_bits":
                adc_kw[kk] = v
            else:
                top_kw[k] = v
        if dac_kw:
            top_kw["dac"] = dataclasses.replace(self.dac, **dac_kw)
        if amu_kw:
            top_kw["amu"] = dataclasses.replace(self.amu, **amu_kw)
        if adc_kw:
            top_kw["adc"] = dataclasses.replace(self.adc, **adc_kw)
        return dataclasses.replace(self, **top_kw)

    @property
    def comparator_count(self) -> int:
        return self.adc.comparator_count


def as_spec(cfg: CIMConfig | MacroSpec) -> MacroSpec:
    """Normalize either operating-point representation to a MacroSpec."""
    return MacroSpec.from_config(cfg)


# The paper's published operating points, in declarative form.
PAPER_MACRO_16ROWS = MacroSpec()
PAPER_MACRO_8ROWS = MacroSpec(amu=AMUSpec(rows_active=8))
