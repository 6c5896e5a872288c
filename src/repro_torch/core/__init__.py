"""Core: the paper's P-8T SRAM CIM macro, weight-stationary, in PyTorch.

The package-level API of the JAX package's ``repro.core`` (its
``__all__``):

  plan_weights(w, cfg [, policy]) -> PlannedWeights
      One-time weight-side work: signed int codes, per-output-channel
      scales, per-column code sums, optional bit-sliced planes.
  execute(x, plan, policy [, generator=]) -> y
      Per-input work: activation quantization, the integer macro matmul
      on a registered backend (``kernels.dispatch``), dequantization.
  plan_params(params [, policy=]) -> params'
      plan_weights over a whole parameter tree.
  register_backend(name, fn) / get_backend / backend_names
      The execution-backend registry.

Quickstart::

    from repro_torch.configs.base import CIMPolicy
    from repro_torch.core import PAPER_OP_16ROWS, execute, plan_weights

    policy = CIMPolicy(mode="cim", cim=PAPER_OP_16ROWS)
    plan = plan_weights(w, policy.cim, policy)   # once
    y0 = execute(x0, plan, policy)               # per batch

The analog side is ``core.pipeline`` (DAC -> AMU -> ADC -> shift-add
stages over a ``MacroSpec``), the macro families are ``core.variants``
and ``core.calibrate`` is the paper's Sec. IV sweep
(``from repro_torch.core.calibrate import calibrate``).
"""

from repro_torch.core.adc import (
    adc_dequant,
    adc_flat_flash,
    adc_read_voltage,
    adc_transfer_int,
    reference_voltages,
)
from repro_torch.core.dac import (
    abl_voltage_from_pmac,
    accumulate_abl,
    dac_voltage,
    multiply_bitcell,
    pmac_from_abl_voltage,
)
from repro_torch.core.energy import (
    MacroEnergyReport,
    adc_energy_comparison,
    energy_per_cycle_j,
    fitted_vt,
    frequency_mhz,
    layer_energy_j,
    macro_report,
    op_energy_j,
    validate_vdd,
    variant_tops_per_w,
)
# NOTE: engine.matmul (the one-shot QAT entry point) is deliberately
# NOT re-exported here — the name would shadow the core.matmul
# submodule attribute; reach it as ``from repro_torch.core import engine``.
from repro_torch.core.engine import (
    PlannedWeights,
    backend_names,
    execute,
    get_backend,
    plan_params,
    plan_weights,
    planned_axes,
    quantized_backend,
    register_backend,
)
# NOTE: the bare ``calibrate`` function is deliberately NOT re-exported
# here — the name would shadow the core.calibrate submodule attribute;
# reach it as ``from repro_torch.core.calibrate import calibrate``.
from repro_torch.core.calibrate import (
    CalibrationGrid,
    CalibrationResult,
    LayerCalibration,
    ParetoPoint,
    RefineMove,
    RefineReport,
    adc_code_table,
    calibrate_resnet,
    calibrated_backend,
    hw_cost,
    load_result,
    refine,
    resnet_eval_fn,
    save_result,
)
from repro_torch.core.macro import MacroOut, macro_op, macro_op_reference_digital
from repro_torch.core.matmul import (
    CIMMode,
    cim_matmul,
    cim_matmul_exact_int,
    cim_matmul_int,
    cim_matmul_ste,
)
from repro_torch.core.params import PAPER_OP_8ROWS, PAPER_OP_16ROWS, CIMConfig
from repro_torch.core.pipeline import (
    ADCSpec,
    ADCStage,
    AMUSpec,
    AMUStage,
    AnalogPipeline,
    DACSpec,
    DACStage,
    MacroSpec,
    MacroState,
    PAPER_MACRO_8ROWS,
    PAPER_MACRO_16ROWS,
    ShiftAddStage,
    Stage,
    default_pipeline,
    default_stages,
)
# The short registry accessors stay namespaced (``variants.get``); the
# package re-exports the aliased forms.
from repro_torch.core.variants import (
    MacroVariant,
    MergedQuant,
    adder_tree_matmul_int,
    get_variant,
    merged_quant,
    merged_transfer_int,
    register_variant,
    variant_names,
)
from repro_torch.core.quant import (
    QuantizedActs,
    QuantizedWeights,
    bitslice_weights,
    dequantize_acts,
    dequantize_weights,
    fake_quant_acts,
    fake_quant_weights,
    plane_signs,
    quantize_acts,
    quantize_weights,
    unslice_weights,
)

__all__ = [
    "ADCSpec",
    "ADCStage",
    "AMUSpec",
    "AMUStage",
    "AnalogPipeline",
    "CIMConfig",
    "CIMMode",
    "CalibrationGrid",
    "CalibrationResult",
    "DACSpec",
    "DACStage",
    "LayerCalibration",
    "MacroEnergyReport",
    "MacroOut",
    "MacroSpec",
    "MacroState",
    "MacroVariant",
    "MergedQuant",
    "PAPER_MACRO_16ROWS",
    "PAPER_MACRO_8ROWS",
    "PAPER_OP_16ROWS",
    "PAPER_OP_8ROWS",
    "ParetoPoint",
    "PlannedWeights",
    "RefineMove",
    "RefineReport",
    "QuantizedActs",
    "QuantizedWeights",
    "ShiftAddStage",
    "Stage",
    "abl_voltage_from_pmac",
    "accumulate_abl",
    "adc_code_table",
    "adc_dequant",
    "adc_energy_comparison",
    "adc_flat_flash",
    "adc_read_voltage",
    "adc_transfer_int",
    "adder_tree_matmul_int",
    "backend_names",
    "bitslice_weights",
    "calibrate_resnet",
    "calibrated_backend",
    "cim_matmul",
    "cim_matmul_exact_int",
    "cim_matmul_int",
    "cim_matmul_ste",
    "dac_voltage",
    "default_pipeline",
    "default_stages",
    "dequantize_acts",
    "dequantize_weights",
    "energy_per_cycle_j",
    "execute",
    "hw_cost",
    "fake_quant_acts",
    "fake_quant_weights",
    "fitted_vt",
    "frequency_mhz",
    "get_backend",
    "get_variant",
    "layer_energy_j",
    "load_result",
    "macro_op",
    "macro_op_reference_digital",
    "macro_report",
    "merged_quant",
    "merged_transfer_int",
    "multiply_bitcell",
    "op_energy_j",
    "plan_params",
    "plan_weights",
    "planned_axes",
    "plane_signs",
    "pmac_from_abl_voltage",
    "quantize_acts",
    "quantize_weights",
    "quantized_backend",
    "reference_voltages",
    "refine",
    "register_backend",
    "register_variant",
    "resnet_eval_fn",
    "save_result",
    "unslice_weights",
    "validate_vdd",
    "variant_names",
    "variant_tops_per_w",
]
