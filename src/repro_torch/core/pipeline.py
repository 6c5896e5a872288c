"""Composable analog macro pipeline: typed, swappable stages.

The macro cycle (DA conversion -> multiply/accumulate -> ADC ->
shift-add) is an :class:`AnalogPipeline` of stage transforms, each
``(state, spec) -> state``:

  DACStage      BL charge-sharing DA conversion (16 local arrays)
  AMUStage      P-8T multiply + eACC ABL charge-sharing accumulation
  ADCStage      coarse-fine flash against the AMU_REF reference columns
  ShiftAddStage digital bit-plane recombination

The operating point is a :class:`MacroSpec`: a composition of per-stage
specs (:class:`DACSpec`, :class:`AMUSpec`, :class:`ADCSpec`).
``MacroSpec`` is attribute-compatible with ``CIMConfig`` (same derived
quantities), so every consumer of an operating point takes either;
``MacroSpec.from_config`` / ``to_config`` convert losslessly. The macro
variants of ``core.variants`` are pipelines with swapped stages.

Hardware noise: ``run(..., generator=)`` on a ``noisy`` spec threads one
``torch.Generator`` through the state; the DAC stage draws one error per
row, then the ADC stage its comparator offsets, in stage order (the
reference splits its key into a DAC and an ADC key instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import dac as dac_lib
from repro_torch.core import quant
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


# ---------------------------------------------------------------------------
# Pipeline state and stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacroState:
    """The typed state a macro cycle threads through the stages.

    Stages read the fields earlier stages produced and fill in their
    own; unset fields are None.

      x_codes    [rows] int input codes (as presented to the macro)
      w_planes   [B, rows, n_out] 0/1 stored bit planes
      x_active   [rows] int codes after the row-activation mask (DAC)
      v_rows     [rows] f32 shared CBL/iBL voltages (DAC)
      v_abl      [n_out, B] f32 accumulated ABL voltages (AMU)
      adc_codes  [n_out, B] int32 flash codes (ADC)
      outputs    [n_out] f32 digital shift-add results (ShiftAdd)
      pmac_ideal [n_out, B] int32 noiseless reference partial MACs
      generator  hardware-noise source (DAC, then ADC draws)
    """

    x_codes: Any = None
    w_planes: Any = None
    x_active: Any = None
    v_rows: Any = None
    v_abl: Any = None
    adc_codes: Any = None
    outputs: Any = None
    pmac_ideal: Any = None
    generator: torch.Generator | None = None

    def evolve(self, **kw) -> "MacroState":
        return dataclasses.replace(self, **kw)


@runtime_checkable
class Stage(Protocol):
    """A pure transform over MacroState: ``stage(state, spec) -> state``."""

    name: str

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        ...


@dataclasses.dataclass(frozen=True)
class DACStage:
    """DA conversion: mask inactive rows, BL charge sharing per row."""

    name: str = "dac"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        x = state.x_codes.to(torch.int32)
        active = torch.arange(spec.rows_per_group, device=x.device) \
            < spec.rows_active
        x_act = torch.where(active, x, torch.zeros_like(x))
        v_rows = dac_lib.dac_voltage(x_act, spec, generator=state.generator)
        return state.evolve(x_active=x_act, v_rows=v_rows)


def _plane_abl(state: MacroState, spec: MacroSpec) -> torch.Tensor:
    """P-8T multiply of every plane column + ABL accumulation: [n_out, B]."""
    # [B, rows, n_out] -> column arrangement [rows, n_out, B].
    w_cols = torch.movedim(state.w_planes, 0, -1).to(torch.float32)
    v_cbl = dac_lib.multiply_bitcell(state.v_rows[:, None, None], w_cols,
                                     spec)
    return dac_lib.accumulate_abl(torch.movedim(v_cbl, 0, -1), spec)


@dataclasses.dataclass(frozen=True)
class AMUStage:
    """P-8T multiplication + eACC ABL charge-sharing accumulation."""

    name: str = "amu"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        return state.evolve(v_abl=_plane_abl(state, spec))


@dataclasses.dataclass(frozen=True)
class ADCStage:
    """Coarse-fine flash readout against the AMU_REF columns."""

    name: str = "adc"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        code = adc_lib.adc_read_voltage(
            state.v_abl, spec, generator=state.generator,
            coarse_bits=spec.adc_coarse_bits,
        )
        return state.evolve(adc_codes=code)


@dataclasses.dataclass(frozen=True)
class ShiftAddStage:
    """Digital recombination of the bit-plane codes into outputs."""

    name: str = "shift_add"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        pmac_hat = adc_lib.adc_dequant(state.adc_codes, spec)
        signs = quant.plane_signs(spec.weight_bits,
                                  pmac_hat.device).to(torch.float32)
        outputs = torch.sum(pmac_hat * signs[None, :], dim=-1)
        return state.evolve(outputs=outputs.to(torch.float32))


def default_stages() -> tuple[Stage, ...]:
    return (DACStage(), AMUStage(), ADCStage(), ShiftAddStage())


@dataclasses.dataclass(frozen=True)
class AnalogPipeline:
    """An ordered composition of analog stages.

    ``run`` drives one macro cycle end to end; ``replace_stage`` swaps
    one stage by name (a different ADC interface, an analog-adder
    accumulation, ...) without touching the rest of the pipeline.
    """

    stages: tuple[Stage, ...] = dataclasses.field(
        default_factory=default_stages
    )

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def stage(self, name: str) -> Stage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"no stage '{name}' in pipeline {self.names}")

    def replace_stage(self, name: str, stage: Stage) -> "AnalogPipeline":
        if name not in self.names:
            raise KeyError(f"no stage '{name}' in pipeline {self.names}")
        return AnalogPipeline(
            stages=tuple(stage if s.name == name else s for s in self.stages)
        )

    def run(
        self,
        x_codes: torch.Tensor,
        w_codes: torch.Tensor,
        spec: MacroSpec | CIMConfig,
        *,
        generator: torch.Generator | None = None,
    ) -> MacroState:
        """One macro cycle: returns the full post-pipeline MacroState."""
        spec = as_spec(spec)
        n = spec.rows_per_group
        if tuple(x_codes.shape) != (n,):
            raise ValueError(
                f"x_codes must be [{n}], got {tuple(x_codes.shape)}")
        planes = quant.bitslice_weights(w_codes, spec.weight_bits)
        state = MacroState(x_codes=x_codes, w_planes=planes,
                           generator=generator)
        for s in self.stages:
            state = s(state, spec)
        if state.x_active is not None:
            pmac_ideal = quant.plane_pmacs(state.x_active,
                                           planes).T.to(torch.int32)
            state = state.evolve(pmac_ideal=pmac_ideal)
        return state


_DEFAULT_PIPELINE = AnalogPipeline()


def default_pipeline() -> AnalogPipeline:
    """The paper's macro as a pipeline (DAC -> AMU -> ADC -> shift-add)."""
    return _DEFAULT_PIPELINE
