"""Hardware-aware ADC calibration results: load, serve, replay.

A :class:`CalibrationResult` holds, per layer, the operating point and
macro variant (``core.variants``: p8t, adder-tree, cell-adc) that the
reference's sweep selected. This module is the execution half of the
reference's ``core/calibrate.py``: a saved result loads
(:func:`load_result`) and registers as an engine backend::

    result = calibrate.load_result("results/calibration/resnet_paper_p8t.json")
    result.register("analog", overwrite=True)
    policy = CIMPolicy(mode="cim-kernel", backend="analog", cim=...)

after which ``engine.execute`` (and so ``models.resnet.forward``) runs
every planned matmul at its layer's calibrated spec, looked up by the
plan's [K, N] shape, through ``kernels.dispatch`` under the layer's
variant: on a CUDA device with a plan that keeps no unpacked planes
that is the variant's hand-written kernel (B1, B2 or B3).

The transfer executed is the one the sweep scored: per-plane variants
derive a pMAC -> code table from their pipeline's ADC stage and replay
it through an explicit lookup (:func:`_lut_matmul_int`) when it differs
from the floor transfer the kernels implement.

The sweep itself (``calibrate``, ``refine``, ``pareto``/``project``,
``summary``, ``effective_tops_per_w``) comes with slice 4 of ROADMAP.md,
as does hardware-noise injection.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import warnings
from typing import Any, Mapping

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import dac, engine
from repro_torch.core import variants as variants_lib
from repro_torch.core.params import CIMConfig
from repro_torch.core.pipeline import (
    AnalogPipeline,
    MacroSpec,
    MacroState,
    default_pipeline,
)
from repro_torch.core.quant import bitslice_weights, plane_signs


@dataclasses.dataclass(frozen=True)
class CalibrationGrid:
    """The swept operating-point axes (paper Fig. 7b grid + ADC split,
    the macro-family axis, and optional cutoff/vdd axes; empty = the
    base spec's value)."""

    adc_bits: tuple[int, ...] = (3, 4, 5)
    rows_active: tuple[int, ...] = (4, 8, 16)
    coarse_bits: tuple[int, ...] = (1, 2)
    variants: tuple[str, ...] = ("p8t",)
    cutoff: tuple[float, ...] = ()
    vdd: tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class PointResult:
    """One (layer x grid point) evaluation of the sweep."""

    spec: MacroSpec
    score: float  # relative L2 error of macro output vs exact-int output
    cost: float  # cmp-evals/MAC or fJ/MAC (CalibrationResult.cost_unit)
    variant: str = "p8t"
    order: int = 0  # grid enumeration index (deterministic tie-break)


@dataclasses.dataclass(frozen=True)
class LayerCalibration:
    """Selected operating point of one layer (``table``: the sweep's
    points, empty for a loaded result; ``skipped``: infeasible points
    with reasons)."""

    name: str
    k: int
    n: int
    spec: MacroSpec
    score: float
    cost: float
    table: tuple[PointResult, ...]
    variant: str = "p8t"
    skipped: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class RefineMove:
    """One attempted greedy move of the accuracy-refinement phase."""

    layer: str
    variant: str
    adc_bits: int
    rows_active: int
    cutoff: float
    vdd: float
    cost_before: float
    cost_after: float
    accuracy: float  # held-out top-1 measured WITH this move applied
    accepted: bool


@dataclasses.dataclass(frozen=True)
class RefineReport:
    """Trace of one refinement run (attached to a refined result)."""

    seed_accuracy: float
    final_accuracy: float
    tol: float
    budget: int
    evals_used: int
    moves: tuple[RefineMove, ...] = ()


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Per-layer operating points selected by the hardware-aware sweep."""

    layers: Mapping[str, LayerCalibration]
    base: MacroSpec
    grid: CalibrationGrid
    slack: float
    # The pipeline the sweep scored against (None for a loaded result:
    # the default pipeline); the registered backend executes its ADC
    # transfer, so scored == executed.
    pipeline: AnalogPipeline | None = None
    cost_unit: str = "cmp-evals/MAC"
    refinement: RefineReport | None = None

    def __post_init__(self) -> None:
        # One-time-warning memo (not a field: eq/hash/replace unaffected).
        self.__dict__["_warned"] = set()

    def _warn_once(self, key: tuple, msg: str) -> None:
        if key not in self.__dict__["_warned"]:
            self.__dict__["_warned"].add(key)
            warnings.warn(msg, stacklevel=3)

    def layer_for(
        self, k: int, n: int, *, strict: bool = False
    ) -> LayerCalibration | None:
        """The calibrated layer with matmul shape [k, n], or None.

        Backends look layers up by weight shape (the only layer identity
        at the matmul boundary). Several calibrated layers of one shape
        with different selections run at the most conservative (highest
        cost) one, with a one-time warning. An unknown shape raises under
        ``strict``, else warns once and returns None (callers fall back
        to ``base``).
        """
        hits = [
            lc for lc in self.layers.values() if (lc.k, lc.n) == (k, n)
        ]
        if not hits:
            if strict:
                raise KeyError(
                    f"no calibrated layer with shape [{k}, {n}]; "
                    f"calibrated shapes: "
                    f"{sorted({(lc.k, lc.n) for lc in self.layers.values()})}"
                )
            self._warn_once(
                ("fallback", k, n),
                f"no calibrated layer with shape [{k}, {n}]: falling "
                f"back to the uncalibrated base spec "
                f"({self.base.adc_bits}-bit ADC, "
                f"{self.base.rows_active} rows). Pass strict=True (or "
                f"calibrate this layer) if that is not intended.",
            )
            return None
        best = max(hits, key=lambda lc: (lc.cost, lc.spec.adc_bits))
        if any(
            (lc.spec, lc.variant) != (best.spec, best.variant)
            for lc in hits
        ):
            self._warn_once(
                ("collision", k, n),
                f"{len(hits)} calibrated layers share shape [{k}, {n}] "
                f"with different operating points "
                f"({sorted(lc.name for lc in hits)}); executing all of "
                f"them at the most conservative one "
                f"('{best.name}': {best.variant}, "
                f"{best.spec.adc_bits}-bit, {best.spec.rows_active} rows).",
            )
        return best

    def spec_for(self, k: int, n: int, *, strict: bool = False) -> MacroSpec:
        """The calibrated spec of the layer with shape [k, n] (``base``
        for an unknown shape unless ``strict``)."""
        lc = self.layer_for(k, n, strict=strict)
        return self.base if lc is None else lc.spec

    def variant_for(self, k: int, n: int, *, strict: bool = False) -> str:
        """The winning macro variant of the layer with shape [k, n]."""
        lc = self.layer_for(k, n, strict=strict)
        return "p8t" if lc is None else lc.variant

    def operating_point(self) -> tuple[int, int]:
        """(adc_bits, rows_active) selected for the majority of layers."""
        counts = collections.Counter(
            (lc.spec.adc_bits, lc.spec.rows_active)
            for lc in self.layers.values()
        )
        return counts.most_common(1)[0][0]

    def register(self, name: str = "analog", *, overwrite: bool = True) -> str:
        """Register this calibration as an engine execution backend: a
        ``CIMPolicy`` with ``backend=name`` then runs every planned
        matmul at its layer's calibrated spec and variant."""
        engine.register_backend(
            name, calibrated_backend(self), overwrite=overwrite
        )
        return name


def adc_code_table(
    pipeline: AnalogPipeline, spec: MacroSpec | CIMConfig
) -> torch.Tensor:
    """pMAC -> code table (int32) derived from the pipeline's ADC stage:
    every pMAC level through the ideal ABL equation and the stage, noise
    off (a pipeline without an "adc" stage reads the floor transfer)."""
    spec = MacroSpec.from_config(spec).replace(noisy=False)
    pmac = torch.arange(spec.pmac_levels, dtype=torch.float32)
    v_abl = dac.abl_voltage_from_pmac(pmac, spec)
    try:
        stage = pipeline.stage("adc")
    except KeyError:
        return adc_lib.adc_transfer_int(pmac, spec)
    state = stage(MacroState(v_abl=v_abl), spec)
    return state.adc_codes.to(torch.int32)


def _grouped_pmac(x_codes: torch.Tensor, planes: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """[M, K] codes x [B, K, N] planes -> [M, G, B, N] group partials
    (exact integers, contracted in float64 on any device)."""
    m, k = x_codes.shape
    b, _, n = planes.shape
    g = -(-k // rows)
    xp = torch.nn.functional.pad(x_codes.to(torch.float64), (0, g * rows - k))
    wp = torch.nn.functional.pad(planes.to(torch.float64),
                                 (0, 0, 0, g * rows - k))
    return torch.einsum("mgr,bgrn->mgbn", xp.reshape(m, g, rows),
                        wp.reshape(b, g, rows, n))


def _planned_pmac(x_codes: torch.Tensor, planes: torch.Tensor,
                  weight_bits: int) -> torch.Tensor:
    """[M, K] codes x plan planes (unpacked [G, B, rows, N] or packed
    [G, rows, N] uint8, grouped at the target rows_active) -> [M, G, B, N]
    partials."""
    m, k = x_codes.shape
    if planes.ndim == 3:  # packed: 8 planes/byte
        planes = bitslice_weights(planes, weight_bits).permute(1, 0, 2, 3)
    g, b, rows, n = planes.shape
    xp = torch.nn.functional.pad(x_codes.to(torch.float64), (0, g * rows - k))
    return torch.einsum("mgr,gbrn->mgbn", xp.reshape(m, g, rows),
                        planes.to(torch.float64))


def _lut_matmul_int(x_codes, w_codes, spec, table, generator,
                    planes=None) -> torch.Tensor:
    """Grouped macro matmul through an explicit ADC code table: the
    transfer the sweep scored, for a pipeline whose ADC differs from the
    floor transfer. ``planes`` reuses a plan's grouped bit planes
    (already at ``spec.rows_active``)."""
    dac._refuse_noise(spec, generator)
    if planes is None:
        sliced = bitslice_weights(w_codes, spec.weight_bits)
        pmac = _grouped_pmac(x_codes, sliced, spec.rows_active)
    else:
        pmac = _planned_pmac(x_codes, planes, spec.weight_bits)
    x = pmac.to(torch.float32)
    idx = torch.clamp(torch.round(x), 0, spec.pmac_levels - 1).long()
    deq = table.to(x.device)[idx].to(torch.float32) * spec.adc_step
    signs = plane_signs(spec.weight_bits, x.device).to(torch.float32)
    return torch.einsum("mgbn,b->mn", deq, signs)


def calibrated_backend(result: CalibrationResult) -> engine.BackendFn:
    """An execution backend running each layer at its calibrated spec.

    The shared quantized epilogue around the macro matmul; the operating
    point and variant are looked up per layer by plan shape:

      * a merged-conversion variant (adder-tree) runs its transfer
        through ``kernels.dispatch``;
      * a per-plane variant (p8t, cell-adc) compares its pipeline's code
        table (at the split-normalized spec the sweep scored) with the
        floor transfer: equal, it runs through ``kernels.dispatch`` under
        the variant's name; different, through that exact table.

    Tables are derived once, here. Hardware noise follows the execution
    policy (``policy.cim.noisy`` with a generator; it raises until
    slice 4).
    """
    from repro_torch.kernels import dispatch  # dispatch imports engine

    pipe = result.pipeline or default_pipeline()
    reachable = {
        (lc.variant, lc.spec) for lc in result.layers.values()
    } | {("p8t", result.base)}
    table_cache: dict[tuple[str, MacroSpec], tuple[bool, Any]] = {}
    for vname, spec in sorted(reachable, key=repr):
        var = variants_lib.get(vname)
        if not var.per_plane_adc:
            continue  # merged conversions execute via dispatch
        vpipe = pipe if vname == "p8t" else var.pipeline
        scored = spec.replace(adc_coarse_bits=0, noisy=False)
        table = adc_code_table(vpipe, scored)
        pmac = torch.arange(spec.pmac_levels, dtype=torch.float32)
        want = adc_lib.adc_transfer_int(pmac, scored)
        table_cache[(vname, spec)] = (bool(torch.equal(table, want)), table)

    def _int_fn(x_codes, plan, cfg, generator):
        lc = result.layer_for(plan.k, plan.n)
        spec = result.base if lc is None else lc.spec
        vname = "p8t" if lc is None else lc.variant
        if spec.act_bits != cfg.act_bits:
            raise ValueError(
                f"calibrated spec act_bits={spec.act_bits} != policy "
                f"act_bits={cfg.act_bits}"
            )
        if spec.weight_bits != plan.weight_bits:
            raise ValueError(
                f"calibrated spec weight_bits={spec.weight_bits} != plan "
                f"weight_bits={plan.weight_bits}"
            )
        run_spec = spec.replace(noisy=cfg.noisy)
        if variants_lib.get(vname).per_plane_adc:
            is_default, table = table_cache[(vname, spec)]
            if not is_default:
                planes = plan.planes
                if (
                    planes is not None
                    and planes.shape[-2] != spec.rows_active
                ):
                    planes = engine.regroup_planes(
                        planes, plan.k, spec.rows_active
                    )
                return _lut_matmul_int(x_codes, plan.codes_i32, run_spec,
                                       table, generator, planes=planes)
        return dispatch.dispatch(
            x_codes, plan.codes, run_spec,
            variant=vname, generator=generator, planes=plan.planes,
            slots=plan.slots,
        )

    return engine.quantized_backend(_int_fn)


# ---------------------------------------------------------------------------
# Persistence: the reference's JSON format, read and written byte for byte
# ---------------------------------------------------------------------------


def _spec_dict(spec: MacroSpec) -> dict:
    return dataclasses.asdict(spec.to_config())


def result_to_dict(result: CalibrationResult) -> dict:
    """JSON-serializable form of the per-layer selections (sweep tables
    and the scored pipeline are not persisted)."""
    payload: dict = {
        "version": 1,
        "base": _spec_dict(result.base),
        "slack": result.slack,
        "cost_unit": result.cost_unit,
        "grid": dataclasses.asdict(result.grid),
        "layers": {
            name: {
                "k": lc.k,
                "n": lc.n,
                "variant": lc.variant,
                "score": lc.score,
                "cost": lc.cost,
                "spec": _spec_dict(lc.spec),
                "skipped": list(lc.skipped),
            }
            for name, lc in result.layers.items()
        },
    }
    if result.refinement is not None:
        payload["refinement"] = dataclasses.asdict(result.refinement)
    return payload


def result_from_dict(payload: dict) -> CalibrationResult:
    if payload.get("version") != 1:
        raise ValueError(
            f"unsupported calibration payload version "
            f"{payload.get('version')!r}"
        )
    refinement = None
    if "refinement" in payload:
        r = dict(payload["refinement"])
        r["moves"] = tuple(RefineMove(**m) for m in r.get("moves", ()))
        refinement = RefineReport(**r)
    layers = {}
    for name, d in payload["layers"].items():
        layers[name] = LayerCalibration(
            name=name, k=int(d["k"]), n=int(d["n"]),
            spec=MacroSpec.from_config(CIMConfig(**d["spec"])),
            score=float(d["score"]), cost=float(d["cost"]),
            table=(), variant=d["variant"],
            skipped=tuple(d.get("skipped", ())),
        )
    return CalibrationResult(
        layers=layers,
        base=MacroSpec.from_config(CIMConfig(**payload["base"])),
        grid=CalibrationGrid(
            **{k: tuple(v) for k, v in payload["grid"].items()}),
        slack=float(payload["slack"]),
        pipeline=None,
        cost_unit=payload.get("cost_unit", "cmp-evals/MAC"),
        refinement=refinement,
    )


def save_result(result: CalibrationResult, path) -> pathlib.Path:
    """Persist a calibration result as deterministic JSON."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps(result_to_dict(result), indent=2, sort_keys=True)
        + "\n"
    )
    return path


def load_result(path) -> CalibrationResult:
    """Load a persisted result (counterpart of :func:`save_result`)."""
    return result_from_dict(json.loads(pathlib.Path(path).read_text()))
