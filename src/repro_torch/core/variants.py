"""Macro-variant stage library: alternative CIM macros as pipelines.

Two macro families from the related literature, expressed as alternative
``AMUStage`` / ``ADCStage`` implementations over the same
:class:`MacroSpec` machinery, plus the paper's own P-8T macro, all
behind one registry::

    variants.get("p8t")        -> MacroVariant (the paper's macro)
    variants.get("adder-tree") -> fully-parallel analog adder network
                                  with a single-ADC interface
                                  (arXiv:2212.04320)
    variants.get("cell-adc")   -> memory cell-embedded ADC with
                                  per-row in-array references
                                  (arXiv:2307.05944)

Each variant bundles:

  pipeline     the voltage-domain AnalogPipeline (swapped stages)
  oracle_int   bit-exact integer reference for one macro cycle
  matmul_int   the scalable integer-domain matmul transfer (grouped
               over rows_active, the signature family of
               ``matmul.cim_matmul_int``)
  hw_cost      comparator evaluations per MAC, amortized over the
               ``weight_bits`` bit-planes a stored weight spans
  adapt_spec   geometry overrides (cell-embedded references free the
               AMU_REF columns for weights)

* **adder-tree**: the B bit-plane ABL charges merge through a
  binary-weighted analog adder (MSB plane inverted, so the two's-
  complement sign is applied in charge), then ONE SAR conversion of
  ``bits_eff = adc_bits + (q_merged - q_full)`` decisions per output
  column; its LSB in pMAC units stays the per-plane ``adc_step``.
* **cell-adc**: the flash readout becomes an in-array successive-
  approximation search of one comparator per column against references
  made by memory cells of dedicated rows; no AMU_REF columns (10
  outputs per macro, not 8). Noise-free codes equal the P-8T floor
  transfer.

Hardware noise (a ``noisy`` spec with a ``torch.Generator``) enters the
merged conversion in the merged domain and the cell-embedded SAR as one
comparator offset per conversion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import dac as dac_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import matmul as matmul_lib
from repro_torch.core import quant
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import (
    AMUStage,
    AnalogPipeline,
    DACStage,
    MacroSpec,
    MacroState,
    ShiftAddStage,
    _plane_abl,
    as_spec,
    default_pipeline,
)

# ---------------------------------------------------------------------------
# Merged-domain quantization (the single-ADC adder-tree interface)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MergedQuant:
    """Quantization constants of the single-ADC merged conversion.

    The analog adder merges the B plane partial-MACs into one signed
    value ``merged = sum_b sign_b 2^b pmac_b``; the single ADC converts
    it with ``bits_eff`` bits sized to the merged range, so the LSB step
    (in pMAC units) equals the per-plane macro's ``adc_step``.
    """

    m_min: int  # most negative merged value (-2^(B-1) * pmac_max)
    m_max: int  # most positive merged value ((2^(B-1)-1) * pmac_max)
    q_merged: int  # full-readout resolution of the merged range
    bits_eff: int  # single-ADC resolution (adc_bits + q_merged - q_full)
    step: float  # LSB in merged (pMAC-weighted) units
    code_min: int  # signed code range of the bipolar conversion
    code_max: int

    @property
    def levels(self) -> int:
        return self.m_max - self.m_min + 1


def merged_quant(spec: MacroSpec | CIMConfig) -> MergedQuant:
    spec = as_spec(spec)
    b = spec.weight_bits
    pmax = spec.pmac_max
    m_min = -(1 << (b - 1)) * pmax
    m_max = ((1 << (b - 1)) - 1) * pmax
    levels = m_max - m_min + 1
    q_merged = max(1, math.ceil(math.log2(levels)))
    bits_eff = spec.adc_bits + (q_merged - spec.q_full)
    threshold = max(1, int(round((1.0 - spec.cutoff) * (1 << q_merged))))
    step = threshold / (1 << bits_eff)
    return MergedQuant(
        m_min=m_min,
        m_max=m_max,
        q_merged=q_merged,
        bits_eff=bits_eff,
        step=step,
        code_min=-(1 << (bits_eff - 1)),
        code_max=(1 << (bits_eff - 1)) - 1,
    )


def merged_sigma(spec: MacroSpec | CIMConfig) -> float:
    """Hardware-noise std-dev in the merged domain: the per-plane sigma
    scaled by the l2 norm of the shift-add weights [1, 2, ..., 2^(B-1)]."""
    spec = as_spec(spec)
    sumsq = sum(4.0 ** b for b in range(spec.weight_bits))
    return spec.replace(noisy=True).sigma_pmac * math.sqrt(sumsq)


def merged_transfer_int(
    merged: torch.Tensor,
    spec: MacroSpec | CIMConfig,
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """merged value -> signed single-ADC code (int32).

    ``floor(merged / step (+ 1/2))`` in float32 with a correctly rounded
    division, so a negative exact multiple of the step reads its own
    code on every device. With ``spec.noisy`` and a generator,
    ``merged_sigma`` Gaussian noise is added first, one draw per element.
    """
    spec = as_spec(spec)
    mq = merged_quant(spec)
    x = merged.to(torch.float32)
    if spec.noisy and generator is not None:
        x = x + merged_sigma(spec) * dac_lib.standard_normal(
            x.shape, generator, x.device)
    half = 0.5 if spec.adc_mode == "nearest" else 0.0
    code = torch.floor(quant.true_divide(x, mq.step) + half)
    return torch.clamp(code, mq.code_min, mq.code_max).to(torch.int32)


def merged_dequant(
    code: torch.Tensor, spec: MacroSpec | CIMConfig
) -> torch.Tensor:
    return code.to(torch.float32) * merged_quant(spec).step


def _merge_planes(pmac: torch.Tensor, weight_bits: int,
                  dim: int) -> torch.Tensor:
    """Exact signed merge sum_b sign_b 2^b pmac_b along ``dim`` (f32)."""
    signs = quant.plane_signs(weight_bits, pmac.device).to(torch.int64)
    shape = [1] * pmac.ndim
    shape[dim] = weight_bits
    merged = torch.sum(pmac.to(torch.int64) * signs.reshape(shape), dim=dim)
    return merged.to(torch.float32)


# ---------------------------------------------------------------------------
# Adder-tree stages (arXiv:2212.04320)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdderTreeAMUStage:
    """Multiply/accumulate + fully-parallel analog adder network.

    The P-8T multiply and per-plane ABL accumulation as the default AMU,
    then a binary-weighted charge-sharing merge of the B plane lines
    (MSB inverted). The merged value is re-encoded as one voltage per
    output on the merged-range scale: ``v_abl`` becomes ``[n_out]``.
    """

    name: str = "amu"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        v_abl = _plane_abl(state, spec)  # [n_out, B]
        pmac = dac_lib.pmac_from_abl_voltage(v_abl, spec)
        signs = quant.plane_signs(spec.weight_bits,
                                  pmac.device).to(torch.float32)
        merged = torch.einsum("ob,b->o", pmac, signs)
        mq = merged_quant(spec)
        shifted = merged - mq.m_min  # [0, levels-1]
        v_merged = spec.vdd * (1.0 - quant.true_divide(shifted, mq.levels))
        return state.evolve(v_abl=v_merged)


@dataclasses.dataclass(frozen=True)
class SingleADCStage:
    """One SAR conversion of ``bits_eff`` decisions per output column.

    The voltage snaps back to the integer merged grid first (the f32
    voltage round trip is far below half a level over the merged range),
    the merged-domain counterpart of the flash model's tie-break epsilon.
    """

    name: str = "adc"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        mq = merged_quant(spec)
        shifted = (1.0 - quant.true_divide(state.v_abl, spec.vdd)) \
            * mq.levels
        merged = torch.round(shifted) + mq.m_min
        gen = state.generator if spec.noisy else None
        code = merged_transfer_int(merged, spec, generator=gen)
        return state.evolve(adc_codes=code)


@dataclasses.dataclass(frozen=True)
class MergedShiftAddStage:
    """Digital epilogue of the single-ADC interface: pure dequant (the
    shift-add already happened in charge)."""

    name: str = "shift_add"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        out = merged_dequant(state.adc_codes, spec)
        return state.evolve(outputs=out.to(torch.float32))


def adder_tree_pipeline() -> AnalogPipeline:
    return AnalogPipeline(
        stages=(
            DACStage(),
            AdderTreeAMUStage(),
            SingleADCStage(),
            MergedShiftAddStage(),
        )
    )


def adder_tree_oracle_int(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: MacroSpec | CIMConfig,
) -> torch.Tensor:
    """Noise-free integer reference for one adder-tree macro cycle."""
    spec = as_spec(cfg).replace(noisy=False)
    x = x_codes.to(torch.int32)
    active = torch.arange(spec.rows_per_group, device=x.device) \
        < spec.rows_active
    x_act = torch.where(active, x, torch.zeros_like(x))
    planes = quant.bitslice_weights(w_codes, spec.weight_bits)  # [B,R,O]
    pmac = torch.einsum("r,bro->bo", x_act.to(torch.int64),
                        planes.to(torch.int64))  # [B, O]
    merged = _merge_planes(pmac, spec.weight_bits, dim=0)
    return merged_dequant(merged_transfer_int(merged, spec), spec)


def adder_tree_matmul_int(
    x_codes: torch.Tensor,
    w_codes: torch.Tensor,
    cfg: MacroSpec | CIMConfig,
    *,
    generator: torch.Generator | None = None,
    planes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped single-ADC matmul in integer units: the scan twin.

    The grouping of ``matmul.cim_matmul_int`` (one macro accumulation
    per ``rows_active`` rows), but each group contributes ONE merged
    conversion per output instead of B per-plane conversions. ``planes``
    takes the plan layouts of ``engine.plan_weights`` (unpacked
    [G, B, rows, N] or bit-packed [G, rows, N] uint8) grouped at
    ``cfg.rows_active``. A Python loop over the G groups; peak memory is
    one [M, B*N] group tile. Noise (``spec.noisy`` with a generator) is
    drawn from the one generator in group order, [M, N] per group (the
    reference folds one key in per group instead).
    """
    spec = as_spec(cfg)
    m, k = x_codes.shape
    rows = spec.rows_active
    b = spec.weight_bits
    k_pad = -(-k // rows) * rows
    g = k_pad // rows
    dev = x_codes.device

    # Group pMACs (<= rows * act_max) are exact in f32 on any device.
    x_p = torch.nn.functional.pad(x_codes.to(torch.float32), (0, k_pad - k))
    x_g = x_p.reshape(m, g, rows).transpose(0, 1)  # [G, M, rows]
    if planes is None:
        if w_codes.shape[0] != k:
            raise ValueError(f"K mismatch: x {tuple(x_codes.shape)}, "
                             f"w {tuple(w_codes.shape)}")
        n = w_codes.shape[1]
        w_p = torch.nn.functional.pad(w_codes.to(torch.int32),
                                      (0, 0, 0, k_pad - k))
        w_g = w_p.reshape(g, rows, n)

        def group_planes(gi):
            return quant.bitslice_weights(w_g[gi], b)
    elif planes.ndim == 3:
        n = planes.shape[-1]
        if tuple(planes.shape) != (g, rows, n):
            raise ValueError(f"packed planes {tuple(planes.shape)} != "
                             f"{(g, rows, n)}")

        def group_planes(gi):
            return quant.bitslice_weights(planes[gi], b)
    else:
        n = planes.shape[-1]
        if tuple(planes.shape) != (g, b, rows, n):
            raise ValueError(f"planes {tuple(planes.shape)} != "
                             f"{(g, b, rows, n)}")

        def group_planes(gi):
            return planes[gi]

    acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for gi in range(g):
        flat = group_planes(gi).to(torch.float32).permute(1, 0, 2)
        pmac = (x_g[gi] @ flat.reshape(rows, b * n)).reshape(m, b, n)
        merged = _merge_planes(pmac, b, dim=1)
        code = merged_transfer_int(merged, spec, generator=generator)
        acc = acc + merged_dequant(code, spec)
    return acc


# ---------------------------------------------------------------------------
# Cell-embedded ADC stage (arXiv:2307.05944)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CellADCStage:
    """In-array successive-approximation readout with per-row refs.

    The reference levels come from memory cells of dedicated reference
    rows (the charge-ratio machinery of ``adc.reference_voltages``), and
    ONE comparator per column binary-searches the ``adc_bits`` decisions
    against them. Noise-free codes equal the flash floor transfer. A
    noisy spec with a generator draws one input-referred offset per
    conversion (the one comparator is reused for every SAR decision).
    """

    name: str = "adc"

    def __call__(self, state: MacroState, spec: MacroSpec) -> MacroState:
        v = state.v_abl
        vrefs = adc_lib.reference_voltages(spec, v.device)  # [2**bits]
        eps = spec.vdd * 1e-6
        offs = torch.zeros_like(v)
        if spec.noisy and state.generator is not None:
            sigma_v = spec.sigma_cmp_mv * 1e-3 * (spec.vdd / 0.6)
            offs = sigma_v * dac_lib.standard_normal(
                v.shape, state.generator, v.device)
        code = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        for bit in range(spec.adc_bits - 1, -1, -1):
            trial = torch.bitwise_or(code, 1 << bit)
            take = v <= vrefs[trial.long()] + offs + eps
            code = torch.where(take, trial, code)
        return state.evolve(adc_codes=code)


def cell_adc_pipeline() -> AnalogPipeline:
    return AnalogPipeline(
        stages=(DACStage(), AMUStage(), CellADCStage(), ShiftAddStage())
    )


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacroVariant:
    """A complete macro family: pipeline + integer transfer + cost.

    ``matmul_int`` has the signature ``(x_codes, w_codes, spec, *,
    generator=None, planes=None)``; ``oracle_int`` is the bit-exact
    noise-free single-cycle reference of the voltage-domain pipeline;
    ``hw_cost`` is comparator evaluations per MAC amortized over the B
    bit-planes of one stored weight (denominator ``rows_active *
    weight_bits`` for every variant).
    """

    name: str
    title: str
    arxiv: str
    pipeline: AnalogPipeline
    oracle_int: Callable[..., torch.Tensor]
    matmul_int: Callable[..., torch.Tensor]
    cost_fn: Callable[[Any], float]
    # Per-plane ADC variants expose a pmac -> code table through their
    # pipeline's adc stage (core.calibrate derives and replays it);
    # merged-conversion variants execute through matmul_int.
    per_plane_adc: bool = True
    # Flash-bank readouts sweep the coarse/fine comparator split; SAR
    # interfaces (one reused comparator) have no such split.
    flash_split: bool = True

    def hw_cost(self, spec: MacroSpec | CIMConfig) -> float:
        return self.cost_fn(as_spec(spec))

    def adapt_spec(self, spec: MacroSpec | CIMConfig) -> MacroSpec:
        """Geometry the variant imposes on an operating point."""
        return as_spec(spec)

    def anchor_spec(self, spec: MacroSpec | CIMConfig) -> MacroSpec:
        """The published-anchor operating point (4-bit, full row group,
        coarse split 1 where the readout has one, cutoff 0.5) in
        ``spec``'s geometry, clamped so tiny geometries stay valid."""
        s = self.adapt_spec(spec)
        anchor = s.replace(rows_active=s.rows_per_group, cutoff=0.5)
        bits = min(4, anchor.q_full)
        coarse = min(1, bits) if self.flash_split else 0
        return anchor.replace(adc_bits=bits, adc_coarse_bits=coarse)


@dataclasses.dataclass(frozen=True)
class _CellADCVariant(MacroVariant):
    def adapt_spec(self, spec: MacroSpec | CIMConfig) -> MacroSpec:
        # Cell-embedded references free the AMU_REF columns: all 80
        # columns store weight planes (10 outputs/macro at 8-bit).
        return as_spec(spec).replace(n_ref_cols=0)


def _p8t_cost(spec: MacroSpec) -> float:
    # B flash conversions of comparator_count each per group-output,
    # over rows * B MACs: the B cancels.
    return spec.comparator_count / spec.rows_active


def _adder_tree_cost(spec: MacroSpec) -> float:
    # ONE SAR conversion of bits_eff decisions per group-output,
    # amortized over the rows * B MACs it covers.
    return merged_quant(spec).bits_eff / (
        spec.rows_active * spec.weight_bits
    )


def _cell_adc_cost(spec: MacroSpec) -> float:
    # B SAR conversions of adc_bits decisions each over rows * B MACs.
    return spec.adc_bits / spec.rows_active


def _p8t_oracle_int(x_codes, w_codes, cfg):
    return macro_lib.macro_op_reference_digital(x_codes, w_codes, cfg)


P8T = MacroVariant(
    name="p8t",
    title="P-8T charge-domain macro (coarse-fine flash, AMU_REF)",
    arxiv="2211.16008",
    pipeline=default_pipeline(),
    oracle_int=_p8t_oracle_int,
    matmul_int=matmul_lib.cim_matmul_int,
    cost_fn=_p8t_cost,
    per_plane_adc=True,
)

ADDER_TREE = MacroVariant(
    name="adder-tree",
    title="Fully-parallel analog adder network, single-ADC interface",
    arxiv="2212.04320",
    pipeline=adder_tree_pipeline(),
    oracle_int=adder_tree_oracle_int,
    matmul_int=adder_tree_matmul_int,
    cost_fn=_adder_tree_cost,
    per_plane_adc=False,
    flash_split=False,
)

CELL_ADC = _CellADCVariant(
    name="cell-adc",
    title="Memory cell-embedded ADC, per-row in-array references",
    arxiv="2307.05944",
    pipeline=cell_adc_pipeline(),
    oracle_int=_p8t_oracle_int,  # same ideal floor transfer (tested)
    matmul_int=matmul_lib.cim_matmul_int,
    cost_fn=_cell_adc_cost,
    per_plane_adc=True,
    flash_split=False,
)

_VARIANTS: dict[str, MacroVariant] = {}


def register(variant: MacroVariant, *, overwrite: bool = False) -> None:
    if variant.name in _VARIANTS and not overwrite:
        raise ValueError(
            f"macro variant '{variant.name}' already registered "
            "(overwrite=True to replace)"
        )
    _VARIANTS[variant.name] = variant


def get(name: str) -> MacroVariant:
    try:
        return _VARIANTS[name]
    except KeyError:
        raise KeyError(
            f"unknown macro variant '{name}'; registered: "
            f"{sorted(_VARIANTS)}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_VARIANTS))


def get_pipeline(name: str) -> AnalogPipeline:
    """The variant's AnalogPipeline (the stage-swap view)."""
    return get(name).pipeline


for _v in (P8T, ADDER_TREE, CELL_ADC):
    register(_v)


# Package-level aliases (core/__init__ re-exports these; the short
# names stay natural for `from repro_torch.core import variants` users).
get_variant = get
variant_names = names
register_variant = register
